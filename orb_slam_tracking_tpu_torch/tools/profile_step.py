"""Where a path's time goes on the GPU, at its operating point.

    python -m orb_slam_tracking_tpu_torch.tools.profile_step
        [--path tracking|init] [--frames 10] [--out FILE.json]

``tracking`` (the default) runs ``TrackingStep`` at the ``entry()`` point
(640x480, 1000 keypoints against an 8192-point map); ``init`` runs
``TwoViewInitializer`` at the ``init_entry()`` point (a rendered 640x480
pair, 2000 keypoints, 200 hypotheses). After a warm-up it
reports, per frame (or pair):

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
import json
import statistics
import time
from collections import defaultdict

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..entry import entry, init_entry
from ..slam import fused_step, two_view_init

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

    Every stage ends in a ``synchronize``, so a device event belongs to the
    stage whose host range holds its start. A stage's range also appears
    on the device timeline as an annotation spanning its work; that is not
    device work and is left out."""
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
        for a, b, name in ranges:
            if a <= start <= b:
                per_stage[name] += us
                break
        else:
            per_stage["outside stages"] += us
    return sum(us for _, us in device), dict(per_stage), launches


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=sorted(_PATHS), default="tracking")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    device = torch.device("cuda", 0)
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
    for k, v in res.items():
        print(f"[profile] {k}: {v}", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
