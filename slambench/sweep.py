"""Sweep the number of streams B of the localization mix on the card, in one
process, to choose a configuration's ``Bench.streamsPerCard``.

    python -m slambench.sweep --config tum3-mono [--streams 64 128 256 512 1024]
        [--seconds 8] [--seed 1]

For each B: the mix's set-up at that B, a window of ``--seconds``, one
profiled call and the card's peak memory. Prints one JSON line per B:
frames/s, seconds a call, the profiled call's device idle share, device
ms and launch calls a batched frame, peak bytes; a B that does not fit
the card's memory, or that the program refuses, is reported with its
error and ends the sweep.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from slambench.cells import BENCH, load_settings, load_traffic
from slambench.mixes.localization import Localization


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="sweep B of the localization mix")
    ap.add_argument("--config", required=True)
    ap.add_argument("--streams", type=int, nargs="+", default=[64, 128, 256, 512, 1024])
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seed", type=int, default=1)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("sweep: no CUDA device", file=sys.stderr)
        return 3
    settings = load_settings(BENCH / "configs" / f"{a.config}.yaml")
    mix = load_traffic("loc-batch")
    for B in a.streams:
        torch.cuda.empty_cache()
        try:
            d = Localization(settings, mix, a.seed, "cuda", streams=B)
            d.setup()
            e2e = d.window(a.seconds)
            r, _ = d.trace()
            row = {"config": a.config, "B": B, "frames_per_s": e2e["frames_per_s"],
                   "call_s": d.call_s, "idle_share": 100.0 * (1.0 - r.busy_s / r.window_s),
                   "device_ms_per_step": r.device_s * 1e3 / d.T,
                   "launch_calls_per_step": r.launches / d.T,
                   "memory_peak_bytes": torch.cuda.max_memory_allocated()}
        except RuntimeError as e:  # out of memory, or a size the program refuses
            print(json.dumps({"config": a.config, "B": B, "error": str(e)[:200]}), flush=True)
            break
        finally:
            d = None
            gc.collect()
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
