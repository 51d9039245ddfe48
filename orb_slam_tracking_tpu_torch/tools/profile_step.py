"""Where a path's time goes on the GPU, at its operating point.

    python -m orb_slam_tracking_tpu_torch.tools.profile_step
        [--path tracking|init|tracker] [--frames 10] [--out FILE.json]

``tracking`` (the default) runs ``TrackingStep`` at the ``entry()`` point
(640x480, 1000 keypoints against an 8192-point map); ``init`` runs
``TwoViewInitializer`` at the ``init_entry()`` point (a rendered 640x480
pair, 2000 keypoints, 200 hypotheses); ``tracker`` runs the sequence
tracker over the ``tracker_entry()`` sequence (see ``profile_tracker``;
``--frames`` is the sequence length there, default 40). For the first
two, after a warm-up it reports, per frame (or pair):

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
import warnings
from collections import defaultdict
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function

from ..entry import entry, init_entry, tracker_entry
from ..slam import fused_step, two_view_init
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


def snapshot(tracker) -> dict:
    """The tracker's state: its map is replaced, never written in place,
    so holding the attributes holds the state (the trajectory list is
    copied; method wrappers set on the instance are left out)."""
    state = {k: v for k, v in vars(tracker).items() if k not in _WRAPPED}
    state["trajectory"] = list(tracker.trajectory)
    return state


def restore(tracker, state: dict) -> None:
    """Put back a ``snapshot``."""
    vars(tracker).update(state)
    tracker.trajectory = list(state["trajectory"])


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
    ap.add_argument("--path", choices=sorted(_PATHS) + ["tracker"], default="tracking")
    ap.add_argument("--frames", type=int, default=None,
                    help="frames (pairs) to time: default 10; the tracker's sequence: 40")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_step needs a CUDA device")
    device = torch.device("cuda", 0)
    if args.path == "tracker":
        return _report(profile_tracker(device, args.frames or 40), args.out)
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
