"""A profiler trace of a few timed calls, reduced to what the per-layer
metrics read.

``traced(fn)`` runs ``fn`` once under ``torch.profiler`` (CPU and CUDA
activities) and returns ``Readings``: the device's busy seconds as the
union of every kernel, copy and fill interval, the traced window's
length on the host clock, the kernel launch calls the host made, the
device seconds by operation, each named kernel family's time and count,
and the longest device idle gaps labelled by the outermost host
operation running when the gap began.
"""

from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch

__all__ = ["Readings", "traced", "LAUNCH_CALLS"]

LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx")


class Readings(NamedTuple):
    window_s: float                           # host wall time of the traced call
    busy_s: float                             # union of the device intervals
    device_s: float                           # sum of the device intervals
    launches: int                             # kernel launch calls on the host
    by_op: List[Tuple[str, float]]            # device seconds by op name, largest first
    families: Dict[str, Tuple[float, int]]    # kernel family -> (seconds, launches)
    idle_gaps: List[Tuple[str, float]]        # longest device idle gaps, labelled


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def _top_level(spans: List[Tuple[float, float, str]]) -> List[Tuple[float, float, str]]:
    """The host spans that no earlier span contains."""
    top: List[Tuple[float, float, str]] = []
    for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
        if not top or a >= top[-1][1]:
            top.append((a, b, name))
    return top


def traced(fn: Callable[[], object], families: Tuple[str, ...] = ()) -> Tuple[object, Readings]:
    """(``fn()``, its readings); ``families`` are kernel name fragments
    whose device time and launch count are kept apart."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    device, host = [], []
    launches = 0
    for e in prof.events():
        a, b = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CUDA:
            device.append((a, b, e.name))
        elif e.name in LAUNCH_CALLS:
            launches += 1
        elif not e.name.startswith(("cuda", "cu", "Profiler")):
            host.append((a, b, e.name))
    if not device:
        raise RuntimeError("the profiler trace holds no device events")
    busy = _union([(a, b) for a, b, _ in device])
    by_op: Dict[str, float] = defaultdict(float)
    fam: Dict[str, List[float]] = {f: [0.0, 0] for f in families}
    for a, b, name in device:
        by_op[name] += (b - a) * 1e-6
        for f in families:
            if f in name:
                fam[f][0] += (b - a) * 1e-6
                fam[f][1] += 1
    top = _top_level(host)
    starts = [a for a, _, _ in top]
    gaps = []
    for (_, end), (nxt, _) in zip(busy[:-1], busy[1:]):
        i = bisect.bisect_right(starts, end) - 1
        label = top[i][2] if i >= 0 and top[i][1] > end else "host"
        gaps.append((label, (nxt - end) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    print(f"trace: {len(device)} device and {len(host)} host events, {launches} launch calls, "
          f"read in {time.perf_counter() - t1:.3f} s", file=sys.stderr)
    return out, Readings(
        window_s=window_s,
        busy_s=sum(b - a for a, b in busy) * 1e-6,
        device_s=sum(b - a for a, b, _ in device) * 1e-6,
        launches=launches,
        by_op=sorted(by_op.items(), key=lambda kv: -kv[1]),
        families={f: (v[0], int(v[1])) for f, v in fam.items()},
        idle_gaps=gaps[:10])
