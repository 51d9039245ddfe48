"""What the program's own recorder (``utils/profiling`` of the port) holds
after a traced call: its resolved spans and its counters' totals, or
``None`` where it holds no span or the program has no recorder, so that
a metric that reads them falls silent rather than raising."""

from __future__ import annotations

import statistics
from typing import Any, Dict, List, Optional, Tuple


def recorded() -> Optional[Tuple[List[Any], Dict[str, Any]]]:
    from orb_slam_tracking_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    if read is None:
        return None
    spans = read()
    return (spans, profiling.counters()) if spans else None


def stream_ms(r: Dict[str, Any], kind: str, name: str) -> Optional[float]:
    """Milliseconds of stream time of every span ``name`` per step of the
    traced call, where the cell is of ``kind`` and there is such a span."""
    got = recorded() if r["kind"] == kind else None
    if got is None:
        return None
    ns = [s.stream_end - s.stream_start for s in got[0] if s.name == name]
    return sum(ns) * 1e-6 / r["steps"] if ns else None


def share(r: Dict[str, Any], kind: str, part: str, whole: str) -> Optional[float]:
    """100 x counter ``part`` / counter ``whole``, in %."""
    got = recorded() if r["kind"] == kind else None
    if got is None or not got[1].get(whole):
        return None
    return 100.0 * got[1].get(part, 0) / got[1][whole]


def host_lead_ms(r: Dict[str, Any], kind: str, prefix: str) -> Optional[float]:
    """The median over the spans whose name starts with ``prefix`` of how
    far the stream reached their close after the host made it, in ms."""
    got = recorded() if r["kind"] == kind else None
    leads = [s.stream_end - s.host_end for s in got[0] if s.name.startswith(prefix)] if got else []
    return statistics.median(leads) * 1e-6 if leads else None
