"""Issue rates of the instructions the port's kernels are built from, on the card.

    python -m orb_slam_tracking_tpu_torch.tools.probe_rates [--out FILE.json]

Builds ``tools/probe_rates.cu`` with the kernel library's nvcc flags, then:

* checks the ``mma.m16n8k256 .b1 and.popc`` fragment layout: one 16 x 8
  tile of popcount(a & b) over 256-bit rows against torch, for the two
  register orders a fragment could take;
* times each probe (f32 add, f32 min/max, DPX three-input min/max,
  xor + popcount + add, the b1 and s8 ``mma.sync``) over a full
  grid with CUDA events, and prints instructions per second, the ratio to
  the f32 add, and per SM per clock taking the f32 add at its documented
  128 per clock per SM;
* counts the SASS opcodes of every kernel of the port's library
  (``cuobjdump -sass``), the static instruction mix behind each design.

Needs a CUDA device and nvcc; prints one line per figure and, with
``--out``, writes them as JSON.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from .. import kernels

SOURCE = Path(__file__).resolve().parent / "probe_rates.cu"
SMS = 132
FADD_PER_CLK_SM = 128  # Hopper's f32 add rate per SM (CUDA programming guide)
CHAINS, MMA_CHAINS = 8, 4  # as in probe_rates.cu
# probe -> (index in probe_launch, output dtype, instructions per thread per
# iteration, or per warp for the mma probes, and the unit they count)
PROBES = {
    "fadd": (0, torch.float32, 2 * CHAINS, "FADD"),
    "fmnmx": (1, torch.float32, 2 * CHAINS, "FMNMX"),
    "vimnmx3": (2, torch.int32, 2 * CHAINS, "three-input DPX min/max"),
    "popc": (3, torch.int32, CHAINS, "POPC (with its xor and add)"),
    "mma_b1_m16n8k256": (4, torch.int32, MMA_CHAINS, "mma per warp"),
    "mma_s8_m16n8k32": (5, torch.int32, MMA_CHAINS, "mma per warp"),
}
THREADS = 256
BLOCKS = SMS * 8


def _build() -> ctypes.CDLL:
    out_dir = kernels.BUILD_ROOT.parent / "probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "libprobe_rates.so"
    cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-shared", "-o", str(lib), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    for line in (proc.stdout + proc.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"[probe] build: {line.strip()}", flush=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode})")
    so = ctypes.CDLL(str(lib))
    so.probe_launch.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_void_p]
    so.probe_mma_b1_tile.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p]
    so.probe_launch.restype = so.probe_mma_b1_tile.restype = ctypes.c_int
    return so


def _b1_layout(so) -> dict:
    g = torch.Generator().manual_seed(0)
    a = torch.randint(-2**31, 2**31, (16, 8), generator=g, dtype=torch.int64).to(torch.int32)
    b = torch.randint(-2**31, 2**31, (8, 8), generator=g, dtype=torch.int64).to(torch.int32)
    x = a[:, None, :] & b[None, :, :]
    want = sum(((x >> k) & 1) for k in range(32)).sum(-1).to(torch.int32)
    res = {}
    stream = torch.cuda.current_stream().cuda_stream
    a_dev, b_dev = a.cuda(), b.cuda()
    for rows_first in (0, 1):
        out = torch.zeros((16, 8), dtype=torch.int32, device="cuda")
        rc = so.probe_mma_b1_tile(a_dev.data_ptr(), b_dev.data_ptr(), out.data_ptr(),
                                  rows_first, stream)
        if rc:
            raise RuntimeError(f"probe_mma_b1_tile launch failed ({rc})")
        torch.cuda.synchronize()
        res["rows_first" if rows_first else "rows_interleaved"] = bool(
            torch.equal(out.cpu(), want))
    return res


def _time(so, which, dtype, iters) -> float:
    out = torch.empty(BLOCKS * THREADS, dtype=dtype, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        rc = so.probe_launch(which, out.data_ptr(), iters, BLOCKS, THREADS, stream)
        if rc:
            raise RuntimeError(f"probe {which} launch failed ({rc})")

    launch()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / 1e3)
    return sorted(times)[len(times) // 2]


def _rates(so) -> dict:
    res = {}
    for name, (which, dtype, per_iter, unit) in PROBES.items():
        per_launch = BLOCKS * (THREADS // 32 if name.startswith("mma") else THREADS) * per_iter
        iters = 64
        t = _time(so, which, dtype, iters)
        iters = max(64, int(iters * 2e-3 / t))  # about 2 ms a launch
        t = _time(so, which, dtype, iters)
        res[name] = {"unit": unit, "iters": iters, "s": t, "per_s": per_launch * iters / t}
    fadd = res["fadd"]["per_s"]
    clock = fadd / (FADD_PER_CLK_SM * SMS)
    for name, r in res.items():
        r["ratio_to_fadd"] = r["per_s"] / fadd
        r["per_clk_per_sm"] = r["per_s"] / clock / SMS
        print(f"[probe] {name}: {r['per_s']:.4g} {r['unit']}/s, {r['ratio_to_fadd']:.4f} of "
              f"the f32 add rate, {r['per_clk_per_sm']:.4g} per SM per clock "
              f"(at the {clock / 1e9:.4f} GHz the f32 add implies)", flush=True)
    res["implied_sm_clock_hz"] = clock
    return res


def _sass() -> dict:
    """Opcode counts per kernel of the port's library."""
    lib = kernels.build_dir() / "libosltt_kernels.so"
    tool = Path(kernels._nvcc()).with_name("cuobjdump")
    text = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if fn and m:
            counts[fn][m.group(1).split(".")[0]] += 1
    for fn, c in counts.items():
        top = ", ".join(f"{k} {v}" for k, v in c.most_common(14))
        print(f"[probe] sass {fn}: {sum(c.values())} instructions; {top}", flush=True)
    return {fn: dict(c) for fn, c in counts.items()}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("probe_rates needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[probe] {smi}", flush=True)
    so = _build()
    layout = _b1_layout(so)
    print(f"[probe] mma.m16n8k256 .b1 and.popc tile equals torch's popcount: {layout}",
          flush=True)
    kernels.library()
    res = {"device": smi, "b1_layout": layout, "rates": _rates(so), "sass": _sass()}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(res, f, indent=1)
    return res


if __name__ == "__main__":
    main()
