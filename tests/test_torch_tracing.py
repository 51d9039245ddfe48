"""The port's spans and counters (``utils/profiling``) on the CPU, and on
the card where there is one.

The recorder: off, ``span`` is one shared null context and nothing is
kept; on under ``torch.profiler`` or ``tracing()``; parents and roots
across nesting; the buffer's bound; counters summed when read; host times
on the profiler's own clock (a span written into ``device_trace``'s
Chrome trace encloses the aten op it wraps). The layers: the batched
``TrackingStep`` under the sequence runner records one ``step.extract``,
two ``step.match`` and two ``step.lm`` a frame, with the matches' visible
slots and the LM's matched rows counted; ``bundle_adjust`` one ``ba.linearize``, ``ba.schur`` and
``ba.factor`` an iteration, with the Schur blocks it computes and those a
count by brute force finds nonzero; and tracing leaves every answer the
same bits. The ``card`` tests (skipped without CUDA) hold the spans'
stream intervals to the profiler's device timeline, and find no profiler
event named after a span. This file imports nothing of JAX, so the card
tests run on the card with ``python -m pytest --noconftest
tests/test_torch_tracing.py``.
"""

from __future__ import annotations

import functools
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from orb_slam_tracking_tpu_torch.config import (CameraConfig, MatcherConfig, OrbConfig,
                                                TrackerConfig)
from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract
from orb_slam_tracking_tpu_torch.optim import ba
from orb_slam_tracking_tpu_torch.parallel import multiseq
from orb_slam_tracking_tpu_torch.slam import fused_step
from orb_slam_tracking_tpu_torch.tools.ba_bench import make_problem
from orb_slam_tracking_tpu_torch.utils import profiling
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame


@pytest.fixture(autouse=True)
def _empty_recorder():
    profiling.clear()
    yield
    profiling.clear()


def _names(spans):
    return Counter(s.name for s in spans)


# --- the recorder --------------------------------------------------------------------------

def test_off_is_the_shared_null_context_and_keeps_nothing():
    a, b = profiling.span("a"), profiling.span("b")
    assert a is b
    with a:
        profiling.count("c", torch.ones(3))
    assert profiling.spans() == []
    assert profiling.counters() == {"profiling.dropped": 0}
    assert profiling._REC.pending == [] and profiling._REC.counts == []


@pytest.mark.parametrize("switch", ["profiler", "tracing"])
def test_on_under_the_profiler_and_under_tracing(switch):
    on = (profile(activities=[ProfilerActivity.CPU]) if switch == "profiler"
          else profiling.tracing())
    with on:
        with profiling.span("a"):
            profiling.count("c", 2)
            torch.ones(4).sum()
    with profiling.span("after"):
        profiling.count("c", 5)
    got = profiling.spans()
    assert [s.name for s in got] == ["a"]
    s = got[0]
    assert s.host_start <= s.host_end and (s.stream_start, s.stream_end) == (s.host_start,
                                                                              s.host_end)
    assert s.self_ns == s.host_end - s.host_start
    assert profiling.counters()["c"] == 2


def test_parent_and_root_across_nesting():
    with profiling.tracing():
        with profiling.span("run"):
            with profiling.span("frame"):
                with profiling.span("step"):
                    pass
            with profiling.span("frame"):
                pass
        with profiling.span("other"):
            with profiling.tracing(), profiling.span("inner"):
                pass
    by = {}
    for s in profiling.spans():
        by.setdefault(s.name, []).append(s)
    run, other = by["run"][0], by["other"][0]
    assert run.parent is None and run.root == run.id
    assert [f.parent for f in by["frame"]] == [run.id, run.id]
    assert by["step"][0].parent == by["frame"][0].id and by["step"][0].root == run.id
    assert by["inner"][0].parent == other.id and by["inner"][0].root == other.id
    assert other.root == other.id != run.id
    # children close first; a parent's self time excludes them
    names = [s.name for s in profiling.spans()]
    assert names.index("step") < names.index("frame") < names.index("run")
    covered = sum(f.stream_end - f.stream_start for f in by["frame"])
    assert run.self_ns == run.stream_end - run.stream_start - covered


def test_the_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(profiling, "LIMIT", 5)
    with profiling.tracing():
        for i in range(8):
            with profiling.span(f"s{i}"):
                pass
        for i in range(7):
            profiling.count("c", 1)
    assert [s.name for s in profiling.spans()] == [f"s{i}" for i in range(5)]
    assert profiling.counters() == {"c": 5, "profiling.dropped": 5}
    profiling.clear()
    with profiling.tracing(), profiling.span("again"):
        pass
    assert [s.name for s in profiling.spans()] == ["again"]
    assert profiling.counters() == {"profiling.dropped": 0}


def test_counters_are_summed_when_read():
    calls = []

    def deferred():
        calls.append(1)
        return 7

    x = torch.tensor([1, 2, 3], dtype=torch.int32)
    with profiling.tracing():
        profiling.count("t", x)
        profiling.count("t", torch.tensor([10], dtype=torch.int32))
        profiling.count("n", 4)
        profiling.count("n", 1.5)
        profiling.count("f", deferred)
        profiling.count("f", deferred)
    assert calls == []
    x.zero_()  # read at resolve: the tensor as it is then
    got = profiling.counters()
    assert got == {"t": 10, "n": 5.5, "f": 14, "profiling.dropped": 0}
    assert calls == [1]
    assert profiling.counters() == got


def test_spans_share_the_profilers_clock(tmp_path):
    """A span around an aten op, inside ``device_trace``: its host interval
    in ``trace.json`` encloses the op's interval within 50 µs."""
    x = torch.ones(384, 384)
    with profiling.device_trace(str(tmp_path)):
        for _ in range(3):
            with profiling.span("mm"):
                torch.mm(x, x)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ops = sorted((e["ts"], e["ts"] + e["dur"]) for e in events if e.get("name") == "aten::mm")
    mine = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("cat") == "program_span" and e.get("tid") == "host")
    assert len(ops) == 3 and len(mine) == 3
    for (a, b), (c, d) in zip(mine, ops):
        assert a <= c + 50.0 and b >= d - 50.0, ((a, b), (c, d))
        assert c - a < 5e3 and b - d < 5e3  # the same clock, not one far off
    assert json.loads((tmp_path / "idle_gaps.json").read_text()) == []


# --- the layers ----------------------------------------------------------------------------

_CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, width=320, height=240)
_ORB = OrbConfig(n_features=200)
_B, _T, _P = 2, 2, 256


@functools.lru_cache(maxsize=1)
def _scene():
    """B streams of T frames of a strafe past a rendered field, from their
    true start poses, against a frozen map of the field points that frame
    0's keypoints describe (within 3 px)."""
    field = CornerField(np.random.default_rng(3), n=300)
    poses = make_trajectory(8, "strafe")
    frames = np.stack([render_frame(field, _CAM, R, t) for R, t in poses[:_T + _B]])
    frames = torch.from_numpy(frames.astype(np.float32))
    kps = orb_extract(frames[0], _ORB, ExtractorConstants(240, 320, _ORB, "cpu"))
    R0, t0 = poses[0]
    pc = field.pts @ R0.T + t0
    uv = pc[:, :2] / pc[:, 2:] * [_CAM.fx, _CAM.fy] + [_CAM.cx, _CAM.cy]
    mp = torch.zeros((_P, 3))
    md = torch.zeros((_P, 8), dtype=torch.int32)
    mv = torch.zeros(_P, dtype=torch.bool)
    n = 0
    for i in torch.nonzero(kps.valid)[:, 0].tolist():
        d = np.linalg.norm(uv - kps.xy[i].numpy(), axis=1)
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < _P:
            mp[n], md[n], mv[n] = torch.from_numpy(field.pts[j]), kps.desc[i], True
            n += 1
    assert n > 30
    images = torch.stack([frames[b:b + _T] for b in range(_B)])
    R = torch.tensor(np.stack([poses[b][0] for b in range(_B)]), dtype=torch.float32)
    t = torch.tensor(np.stack([poses[b][1] for b in range(_B)]), dtype=torch.float32)
    K = torch.tensor([[_CAM.fx, 0, _CAM.cx], [0, _CAM.fy, _CAM.cy], [0, 0, 1]])
    tile = [x.expand((_B,) + x.shape).contiguous() for x in (mp, md, mv)]
    return (images, *tile, R, t, K)


@functools.lru_cache(maxsize=1)
def _runner():
    return multiseq.make_multiseq_sequence_runner(_CAM, _ORB, MatcherConfig(), TrackerConfig(),
                                                  device="cpu")


def test_tracking_step_spans_and_counters(monkeypatch):
    seen, rows, real = [], [], fused_step.search_by_projection

    def search(*a, **k):
        pm = real(*a, **k)
        seen.append(pm.n_visible.clone())
        rows.append(pm.n_matches.clone())
        return pm

    monkeypatch.setattr(fused_step, "search_by_projection", search)
    with profiling.tracing():
        _runner()(*_scene())
    got = profiling.spans()
    assert _names(got) == {"runner.run": 1, "runner.frame": _T, "step.extract": _T,
                           "step.match": 2 * _T, "step.lm": 2 * _T}
    run = next(s for s in got if s.name == "runner.run")
    frames = {s.id for s in got if s.name == "runner.frame"}
    assert all(s.root == run.id for s in got)
    assert all(s.parent in frames for s in got if s.name.startswith("step."))
    c = profiling.counters()
    assert len(seen) == 2 * _T
    assert c["step.visible_slots"] == int(torch.stack(seen).sum()) > 0
    assert c["step.projected_slots"] == 2 * _T * _B * _P
    assert c["step.lm_rows"] == int(torch.stack(rows).sum()) > 0


def test_bundle_adjust_spans_and_schur_fill():
    p = make_problem(0, "local20")
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    n_obs = len(p["obs_kf"])
    obs_valid = torch.from_numpy(np.random.default_rng(1).random(n_obs) > 0.2)
    K = f32([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]])
    fixed = torch.from_numpy(p["kf_fixed"])
    nF, iters = 12, 3
    with profiling.tracing():
        ba.bundle_adjust(f32(p["kf_R0"]), f32(p["kf_t0"]), f32(p["pts0"]),
                         torch.from_numpy(p["obs_kf"]), torch.from_numpy(p["obs_pt"]),
                         f32(p["obs_uv"]), torch.ones(n_obs), obs_valid, fixed,
                         torch.ones(len(p["pts0"]), dtype=torch.bool), K, iterations=iters,
                         max_free_cams=nF)
    got = profiling.spans()
    assert _names(got) == {"ba.bundle_adjust": 1, "ba.linearize": iters, "ba.schur": iters,
                           "ba.factor": iters}
    root = next(s for s in got if s.name == "ba.bundle_adjust")
    assert all(s.parent == root.id for s in got if s is not root)
    # brute force: the in-window ranks of the cameras that see each point
    free = np.flatnonzero(~p["kf_fixed"])[:nF]
    rank = {int(k): r for r, k in enumerate(free)}
    cams = {}
    for o in np.flatnonzero(obs_valid.numpy()):
        k = int(p["obs_kf"][o])
        if k in rank:
            cams.setdefault(int(p["obs_pt"][o]), set()).add(rank[k])
    pairs = {(a, b) for s in cams.values() for a in s for b in s}
    c = profiling.counters()
    assert c["ba.schur_blocks_computed"] == iters * nF * nF
    assert c["ba.schur_blocks_nonzero"] == iters * len(pairs)
    assert 0 < len(pairs) < nF * nF


def test_tracing_leaves_every_answer_the_same_bits():
    args = _scene()
    off = _runner()(*args)
    with profiling.tracing():
        on = _runner()(*args)
    assert off.keys() == on.keys() and all(torch.equal(off[k], on[k]) for k in off)
    assert len(profiling.spans()) == 1 + 6 * _T
    profiling.clear()
    p = make_problem(1, "local20")
    f32 = functools.partial(torch.tensor, dtype=torch.float32)
    n_obs = len(p["obs_kf"])
    prob = (f32(p["kf_R0"]), f32(p["kf_t0"]), f32(p["pts0"]), torch.from_numpy(p["obs_kf"]),
            torch.from_numpy(p["obs_pt"]), f32(p["obs_uv"]), torch.ones(n_obs),
            torch.ones(n_obs, dtype=torch.bool), torch.from_numpy(p["kf_fixed"]),
            torch.ones(len(p["pts0"]), dtype=torch.bool),
            f32([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]]))
    off = ba.bundle_adjust(*prob, iterations=4, early_stop_rel=1e-4)
    with profiling.tracing():
        on = ba.bundle_adjust(*prob, iterations=4, early_stop_rel=1e-4)
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    assert len(profiling.spans()) == 13


# --- on the card ---------------------------------------------------------------------------

def _card_problem():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    p = make_problem(0, "local64")
    dev = torch.device("cuda")
    f32 = functools.partial(torch.tensor, dtype=torch.float32, device=dev)
    n_obs = len(p["obs_kf"])
    prob = (f32(p["kf_R0"]), f32(p["kf_t0"]), f32(p["pts0"]),
            torch.tensor(p["obs_kf"], device=dev), torch.tensor(p["obs_pt"], device=dev),
            f32(p["obs_uv"]), torch.ones(n_obs, device=dev),
            torch.ones(n_obs, dtype=torch.bool, device=dev),
            torch.tensor(p["kf_fixed"], device=dev),
            torch.ones(len(p["pts0"]), dtype=torch.bool, device=dev),
            f32([[450.0, 0, 320.0], [0, 450.0, 240.0], [0, 0, 1]]))
    ba.bundle_adjust(*prob, iterations=2)  # warm-up: cuBLAS and cuSOLVER handles
    torch.cuda.synchronize()
    return prob


@pytest.mark.card
def test_card_stream_intervals_lie_on_the_device_timeline(tmp_path):
    """The profiled solve's kernels lie inside its root span's stream
    interval, within 50 µs, and each step span inside the root's."""
    prob = _card_problem()
    with profiling.device_trace(str(tmp_path)):
        ba.bundle_adjust(*prob, iterations=3)
    trace = json.loads((tmp_path / "trace.json").read_text())
    kernels = [(e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
               if e.get("cat") == "kernel"]
    stream = {e["args"]["id"]: (e["name"], e["ts"], e["ts"] + e["dur"])
              for e in trace["traceEvents"]
              if e.get("cat") == "program_span" and e.get("tid") == "stream"}
    assert kernels and len(stream) == 10
    (root,) = [v for v in stream.values() if v[0] == "ba.bundle_adjust"]
    assert root[1] - 50.0 <= min(a for a, _ in kernels)
    assert max(b for _, b in kernels) <= root[2] + 50.0
    for name, a, b in stream.values():
        assert root[1] <= a <= b <= root[2], name
    leads = [s.stream_end - s.host_end for s in profiling.spans()]
    assert min(leads) > -50_000, leads
    assert isinstance(json.loads((tmp_path / "idle_gaps.json").read_text()), list)


@pytest.mark.card
def test_card_no_profiler_event_carries_a_span_name():
    prob = _card_problem()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba.bundle_adjust(*prob, iterations=2)
        torch.cuda.synchronize()
    names = {s.name for s in profiling.spans()}
    assert names == {"ba.bundle_adjust", "ba.linearize", "ba.schur", "ba.factor"}
    assert not [e.name for e in prof.events() if e.name in names]
