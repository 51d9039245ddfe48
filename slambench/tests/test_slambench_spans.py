"""The readers of the program's spans and counters (``slambench/spans.py``
and the metrics that use it), each given a recorder filled by a fake
trace: the value expected, and nothing for the other cell kind, for an
empty recorder or for a program with no recorder."""

from __future__ import annotations

import pytest

from orb_slam_tracking_tpu_torch.utils import profiling
from slambench.cells import metric_reader

MS = 1_000_000  # ns


def _span(name, i, parent, start_ms, end_ms, lead_ms=0.0, root=0):
    h0, h1 = int(start_ms * MS), int(end_ms * MS)
    s0, s1 = h0 + int(lead_ms * MS), h1 + int(lead_ms * MS)
    return profiling.Span(name, i, parent, root, h0, h1, s0, s1, s1 - s0)


def _loc_trace():
    """Two frames: each one extraction of 3 ms, two matches of 5 and 7 ms
    and two LMs of 11 and 13 ms, the stream behind the host by the lead
    given to each span."""
    out, i = [_span("runner.run", 0, None, 0, 100)], 1
    leads = iter([30.0, 10.0, 20.0, 40.0, 50.0, 0.5, 0.2, 0.1, 0.3, 0.4])
    for f in range(2):
        frame = i
        out.append(_span("runner.frame", frame, 0, 50 * f, 50 * f + 45))
        i += 1
        for name, ms in (("step.extract", 3), ("step.match", 5), ("step.lm", 11),
                         ("step.match", 7), ("step.lm", 13)):
            out.append(_span(name, i, frame, 50 * f, 50 * f + ms, next(leads)))
            i += 1
    return out, {"step.visible_slots": 300, "step.projected_slots": 4 * 2048}


def _ba_trace():
    out = [_span("ba.bundle_adjust", 0, None, 0, 1000)]
    for k in range(3):
        for j, (name, ms) in enumerate((("ba.linearize", 2), ("ba.schur", 30), ("ba.factor", 5))):
            out.append(_span(name, 1 + 3 * k + j, 0, 100 * k, 100 * k + ms))
    return out, {"ba.schur_blocks_nonzero": 3 * 70, "ba.schur_blocks_computed": 3 * 10_000}


def _fill(monkeypatch, trace):
    spans, counts = trace
    monkeypatch.setattr(profiling, "spans", lambda: list(spans))
    monkeypatch.setattr(profiling, "counters", lambda: {**counts, "profiling.dropped": 0})


LOC = {"step.extract_ms_per_step": 3.0, "step.match_ms_per_step": 12.0,
       "step.lm_ms_per_step": 24.0, "step.visible_slot_share": 100.0 * 300 / 8192,
       "runner.host_lead_ms": 5.25}
BA = {"ba.linearize_ms_per_solve": 3.0, "ba.schur_ms_per_solve": 45.0,
      "ba.factor_ms_per_solve": 7.5, "ba.schur_fill_share": 0.7}


@pytest.mark.parametrize("name", sorted(LOC))
def test_loc_reader(monkeypatch, name):
    _fill(monkeypatch, _loc_trace())
    read = metric_reader(name)
    assert read({"kind": "loc", "steps": 2}) == pytest.approx(LOC[name], rel=1e-9)
    assert read({"kind": "ba", "steps": 2}) is None


@pytest.mark.parametrize("name", sorted(BA))
def test_ba_reader(monkeypatch, name):
    _fill(monkeypatch, _ba_trace())
    read = metric_reader(name)
    assert read({"kind": "ba", "steps": 2}) == pytest.approx(BA[name], rel=1e-9)
    assert read({"kind": "loc", "steps": 2}) is None


@pytest.mark.parametrize("name", sorted(LOC) + sorted(BA))
def test_reader_is_silent_without_spans(monkeypatch, name):
    kind = "loc" if name in LOC else "ba"
    _fill(monkeypatch, ([], {}))
    assert metric_reader(name)({"kind": kind, "steps": 2}) is None
    monkeypatch.delattr(profiling, "spans")  # a program without the recorder
    assert metric_reader(name)({"kind": kind, "steps": 2}) is None
