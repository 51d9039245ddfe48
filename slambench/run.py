"""Run one cell of the benchmark once.

    python -m slambench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is found by name in
``BENCHMARK.json``; its traffic mix names the generator (``mixes/``)
that makes its inputs from the seed, warms the program up, runs the
measured window (``--trace 0``: the cell's end-to-end metrics) or a
profiled call (``--trace 1``: its per-layer metrics, read by
``metrics/<name>.py``), then checks the program's answers against the
plain reference. The last line of standard output is one JSON object:
``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
(``breakdown`` with ``--trace 1``) and, last, ``compared``: each number
compared with its limit, which also end standard error. Without a CUDA
device, or with fewer than the cell asks for, it exits with 3 and prints
no result; with the JAX package or JAX loaded, with 4.
"""

from __future__ import annotations

import os
import time

# the process's start, on the clock that times set-up
_UP = float(open("/proc/uptime").read().split()[0])
_STARTED = time.perf_counter() - (_UP - int(open("/proc/self/stat").read().rsplit(")", 1)[1]
                                           .split()[19]) / os.sysconf("SC_CLK_TCK"))

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402

from slambench.cells import find_cell, forbidden_modules, metric_reader  # noqa: E402

__all__ = ["main", "mix_class"]


def mix_class(name: str):
    """The generator a traffic mix names: the one class that
    ``slambench/mixes/<name>.py`` exports, so that a new generator is a
    new file."""
    import importlib

    module = importlib.import_module(f"slambench.mixes.{name}")
    found = [getattr(module, n) for n in module.__all__ if isinstance(getattr(module, n), type)]
    if len(found) != 1:
        raise LookupError(f"slambench.mixes.{name} exports {len(found)} classes, not one")
    return found[0]


def judge(numbers: dict, limits: dict, failed: int) -> bool:
    missing = set(numbers) - set(limits)
    if missing:
        raise KeyError(f"no limit for {sorted(missing)}")
    return failed == 0 and all(math.isfinite(v) and v <= limits[k] for k, v in numbers.items())


def refuse(code: int, msg: str) -> int:
    print(f"slambench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="run one benchmark cell once")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    bad = forbidden_modules(sys.modules)
    if bad:
        return refuse(4, f"loaded at start: {bad}")
    cell = find_cell(a.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        return refuse(3, f"{cell.name} needs {cell.chips} CUDA device(s); found "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    gen = mix_class(cell.mix["generator"])(cell.settings, cell.mix, a.seed)
    gen.setup()
    setup_s = time.perf_counter() - _STARTED
    if a.trace:
        readings, ctx = gen.trace()
    else:
        e2e = gen.window(a.seconds)
    bad = forbidden_modules(sys.modules)
    if bad:
        return refuse(4, f"loaded once the window closed: {bad}")
    peak = torch.cuda.max_memory_allocated()
    attempted, failed = gen.attempted_failed()
    gen.release()
    numbers = gen.check()
    limits = cell.mix["limits"]
    correct = judge(numbers, limits, failed)

    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": cell.chips,
              "memory_peak_bytes": int(peak)}
    from orb_slam_tracking_tpu_torch.utils.profiling import card

    device["card"] = card("cuda:0")
    out = {"correct": correct, "attempted": attempted, "failed": failed}
    if a.trace:
        ctx.update(launches=readings.launches, device_s=readings.device_s,
                   busy_s=readings.busy_s, window_s=readings.window_s,
                   kernels=readings.families, work=gen.kernel_work())
        metrics = {}
        for m in cell.per_layer:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        out["metrics"] = metrics
        device.update(busy_s=readings.busy_s, window_s=readings.window_s)
        out["device"] = device
        out["breakdown"] = {"device_ops": [[n[:64], s] for n, s in readings.by_op[:10]],
                            "idle_gaps": [[n[:64], s] for n, s in readings.idle_gaps]}
    else:
        out["metrics"] = {m["name"]: {"value": (setup_s if m["name"] == "setup_s"
                                                else e2e[m["name"]]), "unit": m["unit"]}
                          for m in cell.end_to_end}
        out["device"] = device
    bad = forbidden_modules(sys.modules)
    if bad:
        return refuse(4, f"loaded by the end of the run: {bad}")
    out["compared"] = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    for k, v in numbers.items():
        print(f"compared {k} {v!r} limit {limits[k]!r}", file=sys.stderr)
    print(f"correct {correct} attempted {attempted} failed {failed}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
