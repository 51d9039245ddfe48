"""Where a path's time goes on the GPU, at its operating point.

    python -m orb_slam_tracking_tpu_torch.tools.profile_step
        [--path tracking|init|tracker|device_loop|ba] [--frames 10] [--out FILE.json]

``tracking`` (the default) runs ``TrackingStep`` at the ``entry()`` point
(640x480, 1000 keypoints against an 8192-point map); ``init`` runs
``TwoViewInitializer`` at the ``init_entry()`` point (a rendered 640x480
pair, 2000 keypoints, 200 hypotheses); ``tracker`` runs the sequence
tracker over the ``tracker_entry()`` sequence (see ``profile_tracker``;
``--frames`` is the sequence length there, default 40); ``device_loop``
runs the device-side mapping loop at the ``device_loop_entry()`` recipe
(see ``profile_device_loop``; ``--frames`` is the loop's length, default
48); ``ba`` times one local BA at the tracker's and at the device loop's
map shapes as shipped and with its deterministic pieces reverted (see
``profile_ba``). For the first two, after a warm-up it reports, per frame
(or pair):

* the step: host-clock ms (to ``synchronize``, median and min) and the
  CUDA-event span (median);
* each stage (tracking: ``orb_extract``, ``search_by_projection`` x2,
  ``optimize_pose`` x2; init: ``orb_extract`` x2,
  ``search_for_initialization``, ``compact_matches``,
  ``initialize_two_view``): host-clock ms per call with a ``synchronize``
  before and after it, so each stage is timed alone;
* from one ``torch.profiler`` trace of ``--frames`` runs: device time (the
  sum of kernel, copy and fill durations), the same split by stage,
  ``cudaLaunchKernel`` calls, and the device's busy share of the
  host-clock time.

Needs a CUDA device; prints one line per figure and, with ``--out``,
writes them as JSON.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import time
import warnings
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..entry import device_loop_entry, entry, init_entry, tracker_entry
from ..optim import ba as ba_module
from ..optim import lm
from ..slam import device_mapping, fused_step, two_view_init
from ..slam.tracker import TrackState

# the module whose forward calls each stage, and the stages' names in it
_PATHS = {
    "tracking": (fused_step, ("orb_extract", "search_by_projection", "optimize_pose")),
    "init": (two_view_init, ("orb_extract", "search_for_initialization",
                             "compact_matches", "initialize_two_view")),
}


@contextlib.contextmanager
def _timed_stages(host_ms, module, stages):
    """Time each stage of the path's forward alone on the host clock
    (``synchronize`` before and after) inside a ``record_function`` range
    named after it; restore the stage functions on exit."""
    saved = {name: getattr(module, name) for name in stages}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(f"stage:{name}"):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for name, fn in saved.items():
        setattr(module, name, wrap(name, fn))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def _device_split(prof):
    """Device µs in total and per stage range, and kernel launch calls.

    Every stage ends in a ``synchronize``, so a device event belongs to each
    stage whose host range holds its start (a nested stage's time counts in
    the stage around it too). A stage's range also appears on the device
    timeline as an annotation spanning its work; that is not device work
    and is left out."""
    ranges, device, launches = [], [], 0
    for e in prof.events():
        if e.name.startswith("stage:"):
            if e.device_type == DeviceType.CPU:
                ranges.append((e.time_range.start, e.time_range.end, e.name[6:]))
        elif e.device_type == DeviceType.CUDA:
            device.append((e.time_range.start, e.time_range.elapsed_us()))
        elif e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"):
            launches += 1
    per_stage = defaultdict(float)
    for start, us in device:
        names = [name for a, b, name in ranges if a <= start <= b] or ["outside stages"]
        for name in names:
            per_stage[name] += us
    return sum(us for _, us in device), dict(per_stage), launches



@contextlib.contextmanager
def tracker_stages(tracker, host_ms):
    """Time the tracker's WORKING frames (``working``), keyframe inserts
    (``insert``, inside a frame) and local BAs (``local_ba``, inside an
    insert) on the host clock, each ending in a ``synchronize``, inside
    ``record_function`` ranges of those names; a frame whose state was
    not WORKING is ``other``. Appends to ``host_ms[name]``."""
    saved = {name: getattr(tracker, name) for name in ("track", "_insert_keyframe", "_local_ba")}

    def wrap(fn, label):
        def timed(*args, **kwargs):
            name = label() if callable(label) else label
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(f"stage:{name}"):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    tracker.track = wrap(saved["track"], lambda: (
        "working" if tracker.state == TrackState.WORKING else "other"))
    tracker._insert_keyframe = wrap(saved["_insert_keyframe"], "insert")
    tracker._local_ba = wrap(saved["_local_ba"], "local_ba")
    try:
        yield
    finally:
        for name in saved:
            delattr(tracker, name)


def count_syncs(fn):
    """Host syncs ``fn()`` makes, by source line, from PyTorch's sync
    detector."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = defaultdict(int)
    for w in caught:
        if "synchroniz" in str(w.message):
            syncs[f"{Path(w.filename).name}:{w.lineno}"] += 1
    return dict(syncs)


# the device loop's stages: the instance's tracking step, recovery tier and
# insert, and inside an insert the module-level calls of device_mapping
_LOOP_STAGES = ("step", "recover", "insert")
_INSERT_STAGES = ("covis_match_triangulate", "hamming_matrix", "bundle_adjust",
                  "update_normal_and_depth")


@contextlib.contextmanager
def loop_stages(loop, host_ms):
    """Time the device loop's stages (``_LOOP_STAGES`` of the loop and
    ``_INSERT_STAGES`` inside an insert; ``hamming_matrix`` there is the
    fuse check's) alone on the host clock, each ending in a
    ``synchronize``, inside ``record_function`` ranges of their names.
    Appends to ``host_ms[name]``."""
    saved = {name: getattr(loop, name) for name in _LOOP_STAGES}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with record_function(f"stage:{name}"):
                out = fn(*args, **kwargs)
                torch.cuda.synchronize()
            host_ms[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return timed

    for name, fn in saved.items():
        setattr(loop, name, wrap(name, fn))
    try:
        with _timed_stages(host_ms, device_mapping, _INSERT_STAGES):
            yield
    finally:
        for name, fn in saved.items():
            setattr(loop, name, fn)


def loop_syncs(loop, run):
    """Host syncs of ``run()`` by source line, -> (outside the loop's
    inserts, inside them, the number of inserts)."""
    outside, inside, n = defaultdict(int), defaultdict(int), [0]
    insert = loop.insert

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        def harvest(into):
            for w in caught:
                if "synchroniz" in str(w.message):
                    into[f"{Path(w.filename).name}:{w.lineno}"] += 1
            del caught[:]

        def counted(*args):
            harvest(outside)
            n[0] += 1
            try:
                return insert(*args)
            finally:
                harvest(inside)

        loop.insert = counted
        torch.cuda.set_sync_debug_mode("warn")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode("default")
            loop.insert = insert
        harvest(outside)
    return dict(outside), dict(inside), n[0]


def profile_device_loop(e, n_frames: int = 48, warm: bool = True) -> dict:
    """The device loop over the first ``n_frames`` frames of a
    ``device_loop_entry`` ``e``: host ms per frame (the run's host clock to
    ``synchronize`` over its frames) and per insert; per stage host ms per
    call (each stage timed alone in another run) and device ms per call
    (from a ``torch.profiler`` trace of a third, device events in each
    stage's range; the insert's stages are inside it); the device's busy
    share; and the host syncs of the frames outside the inserts and of the
    inserts, from a fourth run."""
    frames = e.frames[:n_frames]

    def run():
        return e.loop(frames, *e.args)

    if warm:
        run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, outs = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    n_inserts = int(outs.inserted_kf.sum())
    host = defaultdict(list)
    with loop_stages(e.loop, host):
        run()
    calls = defaultdict(list)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with loop_stages(e.loop, calls):
            run()
    device_us, per_stage_us, launches = _device_split(prof)
    if device_us == 0:
        raise RuntimeError("the profiler trace holds no device events")
    outside, inside, n_ins = loop_syncs(e.loop, run)
    med = statistics.median
    return {
        "path": "device_loop", "frames": n_frames, "inserts": n_inserts,
        "lost": int(outs.lost.sum()), "sequence_host_ms": wall_ms,
        "host_ms_per_frame": wall_ms / n_frames,
        "stage_host_ms_per_call": {k: med(v) for k, v in host.items()},
        "stage_calls": {k: len(v) for k, v in calls.items()},
        "stage_device_ms_per_call": {k: per_stage_us.get(k, 0.0) / 1e3 / len(v)
                                     for k, v in calls.items()},
        "device_ms_per_frame": device_us / 1e3 / n_frames,
        "device_ms_per_insert": per_stage_us.get("insert", 0.0) / 1e3 / max(n_inserts, 1),
        "device_busy_share": device_us / 1e3 / wall_ms,
        "kernel_launch_calls_per_frame": launches / n_frames,
        "syncs_per_frame_outside_inserts": sum(outside.values()) / n_frames,
        "syncs_per_insert": sum(inside.values()) / max(n_ins, 1),
        "sync_sites_outside_inserts": outside, "sync_sites_inserts": inside,
    }


@contextlib.contextmanager
def ba_variant(atomics: bool = False, f32_inverse: bool = False):
    """Local BA with its deterministic pieces reverted, for comparison:
    ``atomics`` sums the segments with ``index_add_`` over every
    observation (float atomics on the card, the form before the sorted
    segment sums), ``f32_inverse`` forms the point blocks' inverses by the
    f32 adjugate."""
    saved = (ba_module.segments, ba_module.segment_sum, ba_module.inv3x3)
    if atomics:
        ba_module.segments = lambda idx, n, valid=None: (idx.long(), n)
        ba_module.segment_sum = lambda vals, seg: torch.zeros(
            (seg[1],) + vals.shape[1:], dtype=vals.dtype, device=vals.device).index_add_(
                0, seg[0], vals)
    if f32_inverse:
        ba_module.inv3x3 = lambda M: lm.inv3x3(M.to(torch.float32))
    try:
        yield
    finally:
        ba_module.segments, ba_module.segment_sum, ba_module.inv3x3 = saved


def _ba_args_of(run, module, name="bundle_adjust"):
    """The arguments of the first ``module.name`` call that ``run()`` makes."""
    found = []
    fn = getattr(module, name)

    def record(*args, **kwargs):
        if not found:
            found.append((args, kwargs))
        return fn(*args, **kwargs)

    setattr(module, name, record)
    try:
        run()
    finally:
        setattr(module, name, fn)
    return found[0]


def profile_ba(device, runs: int = 10) -> dict:
    """One local BA from a fixed map state at the tracker's shape (the
    first local BA of the ``tracker_entry`` sequence from frame 24 on:
    2048 points, 16 keyframes, 8192 observations) and at the device loop's
    (its first insert at the ``device_loop_entry`` recipe: 8192 points, 24
    keyframes, 12288 observations), BA window 8: device ms per BA
    (``torch.profiler``, ``runs`` calls), as shipped and with each
    deterministic piece reverted (``ba_variant``); and for each, whether
    ``runs`` results are bit-identical."""
    from ..slam import tracker as tracker_module

    tracker, frames, _ = tracker_entry(device)
    run_sequence(tracker, frames[:24])
    tr_args = _ba_args_of(lambda: run_sequence(tracker, frames[24:], 24), tracker_module)
    e = device_loop_entry(device, 8)
    dl_args = _ba_args_of(lambda: e.loop(e.frames, *e.args), device_mapping)
    variants = {"shipped": {}, "atomics": {"atomics": True}, "f32_inverse": {"f32_inverse": True},
                "before": {"atomics": True, "f32_inverse": True}}
    res = {"path": "ba", "runs": runs}
    for shape, (args, kwargs) in (("tracker", tr_args), ("device_loop", dl_args)):
        res[f"{shape}_shape"] = {"points": args[2].shape[0], "keyframes": args[0].shape[0],
                                 "observations": args[3].shape[0],
                                 "valid_observations": int(args[7].sum())}
        for name, kw in variants.items():
            with ba_variant(**kw):
                def one():
                    return ba_module.bundle_adjust(*args, **kwargs)
                outs = [one() for _ in range(runs)]
                same = all(all(torch.equal(x, y) for x, y in zip(o, outs[0])) for o in outs)
                ms = _device_ms(one, runs)
            res[f"{shape}_{name}_device_ms"] = ms
            res[f"{shape}_{name}_repeats_bit_for_bit"] = same
    return res


def _device_ms(fn, runs: int) -> float:
    """Device ms of one ``fn()``: the device events of ``runs`` calls in a
    ``torch.profiler`` trace, summed, over ``runs``."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(runs):
            fn()
        torch.cuda.synchronize()
    us, _, _ = _device_split(prof)
    if us == 0:
        raise RuntimeError("the profiler trace holds no device events")
    return us / 1e3 / runs


def run_sequence(tracker, frames, start: int = 0):
    """Track ``frames`` as frames ``start``, ``start + 1``, ... at 30 fps;
    -> each frame's metrics."""
    return [tracker.track(f, i / 30.0) for i, f in enumerate(frames, start)]


def profile_tracker(device, n_frames: int = 40) -> dict:
    """The sequence tracker over ``tracker_entry``'s frames, after one
    warm-up sequence: host ms per WORKING frame (with and without a
    keyframe insert), per insert and per local BA (each median, from a run
    that times them alone); their device ms from a ``torch.profiler`` trace
    of another run (device events in each range, per call; a local BA is
    inside its insert, an insert inside its frame; the init map's BA is a
    local BA of an ``other`` frame); the device's busy share (the traced
    run's device ms over the timed run's host ms); and the host syncs of
    one WORKING frame without an insert and of one insert, taken again
    from the map state before them."""
    run_sequence(*tracker_entry(device, n_frames)[:2])  # lazy init, kernel build
    tracker, frames, _ = tracker_entry(device, n_frames)
    host = defaultdict(list)
    t0 = time.perf_counter()
    with tracker_stages(tracker, host):
        metrics = run_sequence(tracker, frames)
    wall_ms = (time.perf_counter() - t0) * 1e3
    inserted = ["kf" in m for m in metrics if m["state"] == "WORKING"]
    plain = [ms for ms, kf in zip(host["working"], inserted) if not kf]
    with_kf = [ms for ms, kf in zip(host["working"], inserted) if kf]

    tracker, frames, _ = tracker_entry(device, n_frames)
    calls = defaultdict(list)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with tracker_stages(tracker, calls):
            run_sequence(tracker, frames)
    device_us, per_stage_us, launches = _device_split(prof)
    if device_us == 0:
        raise RuntimeError("the profiler trace holds no device events")
    dev = {k: v / 1e3 for k, v in per_stage_us.items()}

    # syncs from fixed states: the first WORKING frame without an insert and
    # the first insert of a fresh run, each taken once more from before it
    tracker, frames, _ = tracker_entry(device, n_frames)
    working = [i for i, m in enumerate(metrics) if m["state"] == "WORKING"]
    first_plain = next((i for i in working if "kf" not in metrics[i]), working[0])
    run_sequence(tracker, frames[:first_plain])
    snap = snapshot(tracker)
    frame_syncs = count_syncs(lambda: tracker.track(frames[first_plain], first_plain / 30.0))
    restore(tracker, snap)
    state, args = next_insert(tracker, frames, first_plain)
    restore(tracker, state)
    insert_syncs = count_syncs(lambda: tracker._insert_keyframe(*args))

    med = statistics.median
    n = {k: len(v) for k, v in calls.items()}
    return {
        "path": "tracker", "frames": n_frames, "sequence_host_ms": wall_ms,
        "working_frames": len(host["working"]), "inserts": len(host["insert"]),
        "host_ms_per_working_frame": med(host["working"]),
        "host_ms_per_working_frame_without_insert": med(plain) if plain else None,
        "host_ms_per_working_frame_with_insert": med(with_kf) if with_kf else None,
        "host_ms_per_insert": med(host["insert"]),
        "host_ms_per_local_ba": med(host["local_ba"]),
        "host_ms_per_other_frame": med(host["other"]),
        "device_ms_per_working_frame": dev["working"] / n["working"],
        "device_ms_per_insert": dev["insert"] / n["insert"],
        "device_ms_per_local_ba": dev["local_ba"] / n["local_ba"],
        "device_ms_per_other_frame": dev["other"] / n["other"],
        "device_ms_sequence": device_us / 1e3,
        "device_busy_share": device_us / 1e3 / wall_ms,
        "kernel_launch_calls_sequence": launches,
        "syncs_per_working_frame_without_insert": sum(frame_syncs.values()),
        "syncs_per_insert": sum(insert_syncs.values()),
        "sync_sites_working_frame": frame_syncs, "sync_sites_insert": insert_syncs,
    }


_WRAPPED = ("track", "_insert_keyframe", "_local_ba")


def _closer_copy(closer):
    """A copy of a loop closer whose consistency groups are its own (its
    other state is replaced, never written in place)."""
    if closer is None:
        return None
    out = copy.copy(closer)
    out._groups = list(closer._groups)
    return out


def snapshot(tracker) -> dict:
    """The tracker's state: its map and keyframe database are replaced,
    never written in place, so holding the attributes holds the state (the
    trajectory list and the loop closer are copied; method wrappers set on
    the instance are left out)."""
    state = {k: v for k, v in vars(tracker).items() if k not in _WRAPPED}
    state["trajectory"] = list(tracker.trajectory)
    state["loop_closer"] = _closer_copy(tracker.loop_closer)
    return state


def restore(tracker, state: dict) -> None:
    """Put back a ``snapshot``."""
    vars(tracker).update(state)
    tracker.trajectory = list(state["trajectory"])
    tracker.loop_closer = _closer_copy(state["loop_closer"])


def state_before(tracker, name: str, run):
    """Run ``run()`` until the tracker first calls its method ``name``;
    -> (the tracker's state just before that call, the call's arguments).
    The call and what ``run`` does after it do not happen: restore a state
    after this."""
    found = {}

    class Found(Exception):
        pass

    def capture(*args):
        found.update(state=snapshot(tracker), args=args)
        raise Found

    setattr(tracker, name, capture)
    try:
        run()
        raise RuntimeError(f"the tracker never called {name}")
    except Found:
        return found["state"], found["args"]
    finally:
        delattr(tracker, name)


def next_insert(tracker, frames, start: int):
    """Track from frame ``start`` until a keyframe insert begins; -> (the
    state just before it, its arguments), as ``state_before``."""
    return state_before(tracker, "_insert_keyframe",
                        lambda: run_sequence(tracker, frames[start:], start))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(_PATHS) + ["tracker", "device_loop", "ba"],
                    default="tracking")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames (pairs) to time: default 10; the tracker's sequence: 40; "
                         "the device loop's: 48")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    device = torch.device("cuda", 0)
    if args.path == "tracker":
        return _report(profile_tracker(device, args.frames or 40), args.out)
    if args.path == "ba":
        return _report(profile_ba(device), args.out)
    if args.path == "device_loop":
        n = args.frames or 48
        return _report(profile_device_loop(device_loop_entry(device, n), n), args.out)
    args.frames = args.frames or 10
    forward, inputs = (entry if args.path == "tracking" else init_entry)(device)[:2]
    module, stages = _PATHS[args.path]
    for _ in range(3):  # lazy CUDA, cuBLAS and kernel-library initialisation
        forward(*inputs)
    torch.cuda.synchronize()

    host, span = [], []
    for _ in range(args.frames):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        forward(*inputs)
        end.record()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
        span.append(start.elapsed_time(end))

    stage_ms = defaultdict(list)
    with _timed_stages(stage_ms, module, stages):
        for _ in range(args.frames):
            forward(*inputs)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(args.frames):
            forward(*inputs)
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_stages:
        with _timed_stages(defaultdict(list), module, stages):
            for _ in range(args.frames):
                forward(*inputs)
    device_us, _, launches = _device_split(prof)
    staged_us, per_stage_us, _ = _device_split(prof_stages)
    if device_us == 0:
        raise RuntimeError("the profiler trace holds no device events")

    n = args.frames
    step_ms = statistics.median(host)
    res = {
        "path": args.path,
        "frames": n,
        "step_ms_median": step_ms, "step_ms_min": min(host),
        "step_event_span_ms_median": statistics.median(span),
        "stage_host_ms_per_call": {k: statistics.median(v) for k, v in stage_ms.items()},
        "stage_calls_per_frame": {k: len(v) // n for k, v in stage_ms.items()},
        "device_ms_per_frame": device_us / 1e3 / n,
        "stage_device_ms_per_frame": {k: v / 1e3 / n for k, v in per_stage_us.items()},
        "staged_trace_device_ms_per_frame": staged_us / 1e3 / n,
        "kernel_launch_calls_per_frame": launches / n,
        "device_busy_share": device_us / 1e3 / n / step_ms,
    }
    return _report(res, args.out)


def _report(res: dict, out) -> dict:
    for k, v in res.items():
        print(f"[profile] {k}: {v}", flush=True)
    if out:
        with open(out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
