"""The readings that a cell's limits are set from, on the card, in one
process: the program's compared numbers on many seeds (one call or solve
of the timed path each, at the cell's own size) and the control's, the
plain reference computed with TF32 on in the program's place.

    python -m slambench.limits --workload <name> --program-seeds S [S ...]
        --control-seeds S [S ...] [--gaps FILE]

Prints one JSON line per seed and side, then the largest of each side;
with ``--gaps``, appends each comparison's gaps pair by pair to FILE
(one JSON line per seed and side), from which a tail's threshold is
read. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from slambench.cells import find_cell
from slambench.run import mix_class


def readings(workload: str, program_seeds, control_seeds, out=sys.stdout, gaps=None):
    cell = find_cell(workload)
    cls = mix_class(cell.mix["generator"])
    worst = {"program": {}, "control": {}}
    for side, seeds in (("program", program_seeds), ("control", control_seeds)):
        for seed in seeds:
            d = cls(cell.settings, cell.mix, seed)
            if side == "program":
                d.setup()
                d.window(0.0)
                d.release()
                nums = d.check()
            else:
                d.inputs()
                nums = d.control()
            print(json.dumps({"workload": workload, "side": side, "seed": seed, **nums}),
                  file=out, flush=True)
            if gaps is not None and getattr(d, "gaps", None) is not None:
                with open(gaps, "a") as f:
                    f.write(json.dumps({"workload": workload, "side": side, "seed": seed,
                                        **d.gaps}) + "\n")
            pick = max if side == "program" else min
            for k, v in nums.items():
                worst[side][k] = pick(worst[side].get(k, v), v)
            d = None
            torch.cuda.empty_cache()
    print(json.dumps({"workload": workload, "program_largest": worst["program"],
                      "control_least": worst["control"]}), file=out, flush=True)
    return worst


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--program-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--gaps", default=None)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("limits: no CUDA device", file=sys.stderr)
        return 3
    readings(a.workload, a.program_seeds, a.control_seeds, gaps=a.gaps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
