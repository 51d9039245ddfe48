"""Tracing and profiling helpers (counterpart of ``utils/profiling.py``).

- ``Stopwatch``: accumulating named wall-clock sections, mean and total;
- ``device_trace``: ``torch.profiler`` over the CPU and, where there is a
  card, CUDA activities, written as a Chrome trace (per-kernel device time);
- ``MetricsLog``: append-only per-frame metrics with JSONL export.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List

__all__ = ["Stopwatch", "device_trace", "MetricsLog"]


class Stopwatch:
    def __init__(self):
        self._total: Dict[str, float] = defaultdict(float)
        self._count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def section(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._total[name] += time.perf_counter() - t0
            self._count[name] += 1

    def report(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {
                "total_s": self._total[k],
                "count": self._count[k],
                "mean_ms": 1000.0 * self._total[k] / max(self._count[k], 1),
            }
            for k in sorted(self._total)
        }

    def __str__(self) -> str:
        return "\n".join(
            f"{k:30s} {v['mean_ms']:8.2f} ms x{v['count']:<5d} = {v['total_s']:.2f}s"
            for k, v in self.report().items()
        )


@contextlib.contextmanager
def device_trace(logdir: str) -> Iterator[object]:
    """Profile the block with ``torch.profiler`` (CUDA activities too when a
    card is present) and write ``logdir/trace.json`` (Chrome trace format);
    yields the profiler, whose ``key_averages()`` sum the time by kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class MetricsLog:
    """Per-frame metrics rows with JSONL export."""

    def __init__(self):
        self.rows: List[dict] = []

    def append(self, row: dict) -> None:
        self.rows.append(row)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for row in self.rows:
                f.write(json.dumps(row, default=str) + "\n")

    def summary(self) -> dict:
        """Mean, min and max of each numeric key of the last row."""
        if not self.rows:
            return {}
        keys = [k for k, v in self.rows[-1].items() if isinstance(v, (int, float))]
        out = {}
        for k in keys:
            vals = [r[k] for r in self.rows if isinstance(r.get(k), (int, float))]
            if vals:
                out[k] = {"mean": sum(vals) / len(vals), "min": min(vals), "max": max(vals)}
        return out
