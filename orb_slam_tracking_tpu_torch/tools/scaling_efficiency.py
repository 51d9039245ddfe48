"""Strong and weak scaling of the multi-device modes over ranks: the
counterpart of the JAX package's ``scripts/scaling_efficiency.py``.

    python -m orb_slam_tracking_tpu_torch.tools.scaling_efficiency [--shared-card] [--cpu]
        [--skip-multiseq] [--json OUT]

1. Strong scaling of the point-sharded Schur BA (``parallel/ba_sharded``):
   the 20-keyframe / 8,192-point / 40,960-observation problem
   (``utils/synthetic.strong_scaling_ba_problem``, the JAX script's draws),
   the first two keyframes fixed, 10
   LM iterations, its points sharded over N ranks. Per N: ms a solve (host
   clock to ``synchronize``, the median of ``REPS`` solves after one
   warm-up), LM iters/s, the final cost; the all-reduce payload of one LM
   iteration, counted from the calls the solve makes (the port packs the
   four camera-sized sums of the JAX module into one buffer, and sums the
   cost and the predicted gain in a second); and the measured time of
   those collectives a iteration, the same calls on buffers of the same
   sizes replayed alone between ``synchronize`` calls.
2. Weak scaling of DP (``parallel/multiseq.make_multiseq_sequence_runner``
   with the group): B = N sequences of ``MS_FRAMES`` frames on the JAX
   script's recipe (240x320, 256 features over 4 levels, a 512-point
   random map, random frames, seed 0, built with numpy as its are), one
   sequence a rank. Per N: ms a run (the median of ``REPS`` runs after
   one warm-up) and aggregate frames/s. No collective runs inside a run.

Which ranks run: on the card, NCCL with one rank a card for N up to the
card count. A larger N runs only under ``--shared-card``, as gloo ranks
that share the cards (rank r on card r % count), and its record says so;
otherwise it is recorded as not run. ``--cpu`` runs gloo ranks on the
CPU, whose times are no device metric. Every record carries ``backend``,
``cards``, ``ranks_per_card`` and the card's name and power limit. The
ranks of one N are ``parallel.distributed.spawn``'s processes, one spawn
an N for both measurements.

Prints one JSON line a record and writes, with ``--json``, the JAX
script's fields (``results``, ``psum_payload_bytes``) and ``device``.
Ranks that share a card, or the CPU, time-share it: their times say
nothing of scaling across cards.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from unittest import mock

import numpy as np
import torch
import torch.distributed as dist

from ..config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..parallel.ba_sharded import bucket_observations, bundle_adjust_sharded
from ..parallel.distributed import make_global_array, replicate, spawn
from ..parallel.multiseq import make_multiseq_sequence_runner
from ..utils.profiling import card
from ..utils.synthetic import strong_scaling_ba_problem

__all__ = ["NKF", "NPTS", "OBS_PER_PT", "BA_ITERS", "allreduce_bytes_per_iteration",
           "plan", "measure", "main"]

NKF = 20
NPTS = 8192
OBS_PER_PT = 5
BA_ITERS = 10
FIXED = 2
SLACK = 256        # shard capacity over O / N, for the buckets' imbalance
MS_FRAMES = 24
MS_HW = (240, 320)
MS_FEATURES = 256
MS_MAP = 512
SEED = 0
REPS = 3           # timed solves or runs after one warm-up
NS = (1, 2, 4, 8)  # rank counts


def allreduce_bytes_per_iteration(n_kf: int, n_free: int, itemsize: int = 4) -> int:
    """The all-reduce payload of one LM iteration of ``bundle_adjust_sharded``
    with ``n_kf`` cameras and a window of ``n_free``: U [K,6,6], the camera
    gradient [K,6], S [F,6,F,6] and the right-hand side [F,6] in one
    buffer, then the new cost and the points' predicted gain."""
    return itemsize * (36 * n_kf + 6 * n_kf + 36 * n_free * n_free + 6 * n_free + 2)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _recorded_allreduces(calls: list):
    """Every ``dist.all_reduce`` made inside: its (numel, dtype) in ``calls``."""
    inner = dist.all_reduce

    def counted(tensor, *args, **kw):
        calls.append((tensor.numel(), tensor.dtype))
        return inner(tensor, *args, **kw)

    with mock.patch.object(dist, "all_reduce", counted):
        yield


def _ba_strong(mesh, n_points: int, reps: int) -> dict:
    dev, n = mesh.device, mesh.size
    kf_R, kf_t, pts0, obs_kf, obs_pt, obs_uv, K = strong_scaling_ba_problem(
        SEED, NKF, n_points, OBS_PER_PT)
    O = len(obs_kf)
    bk, bp, buv, bw, bv = bucket_observations(obs_kf, obs_pt, obs_uv, np.ones(O, np.float32),
                                              np.ones(O, bool), n_points, n, O // n + SLACK)
    fixed = np.zeros(NKF, bool)
    fixed[:FIXED] = True
    G = [make_global_array(mesh, a) for a in (pts0, bk, bp, buv, bw, bv)]
    rep = [replicate(mesh, a) for a in (kf_R, kf_t)]
    tail = (replicate(mesh, fixed), make_global_array(mesh, np.ones(n_points, bool)),
            replicate(mesh, K))

    def solve():
        return bundle_adjust_sharded(*rep, *G, *tail, iterations=BA_ITERS, group=mesh.group)

    calls = []
    with _recorded_allreduces(calls):
        cost = float(solve()[3])   # the warm-up, its collectives counted
    per_iter = calls[1:]           # the first sums the starting cost, once a solve
    if len(per_iter) % BA_ITERS:
        raise RuntimeError(f"{len(per_iter)} all-reduces in {BA_ITERS} LM iterations")
    per_iter = per_iter[:len(per_iter) // BA_ITERS]
    times = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        solve()
        _sync(dev)
        times.append(time.perf_counter() - t0)
    bufs = [torch.zeros(numel, dtype=dtype, device=dev) for numel, dtype in per_iter]
    dist.barrier()
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(BA_ITERS):
        for b in bufs:
            dist.all_reduce(b, group=mesh.group)
    _sync(dev)
    coll = (time.perf_counter() - t0) / BA_ITERS
    dt = statistics.median(times)
    return {"bench": "ba_strong", "n": n, "ms_per_solve": dt * 1e3,
            "ms_per_solve_reps": [x * 1e3 for x in times], "iters_per_s": BA_ITERS / dt,
            "final_cost": cost, "points": n_points,
            "psum_payload_bytes": sum(numel * torch.empty((), dtype=dtype).element_size()
                                      for numel, dtype in per_iter),
            "allreduce_calls_per_iter": len(per_iter), "collective_ms_per_iter": coll * 1e3}


def _multiseq_weak(mesh, frames: int, reps: int) -> dict:
    dev, n = mesh.device, mesh.size
    h, w = MS_HW
    cam = CameraConfig(fx=300.0, fy=300.0, cx=w / 2, cy=h / 2, width=w, height=h, fps=30.0)
    orb = OrbConfig(n_features=MS_FEATURES, n_levels=4)
    rng = np.random.default_rng(SEED)
    B, P = n, MS_MAP
    imgs = rng.uniform(0, 255, (B, frames, h, w)).astype(np.float32)
    pts = np.stack([rng.uniform(-3, 3, (B, P)), rng.uniform(-2, 2, (B, P)),
                    rng.uniform(3, 9, (B, P))], -1).astype(np.float32)
    desc = rng.integers(0, 2 ** 32, (B, P, 8), dtype=np.uint32).view(np.int32)
    valid = np.ones((B, P), bool)
    R0 = np.broadcast_to(np.eye(3, dtype=np.float32), (B, 3, 3)).copy()
    t0_ = np.zeros((B, 3), np.float32)
    K = np.array([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], np.float32)
    args = [torch.tensor(a, device=dev) for a in (imgs, pts, desc, valid, R0, t0_, K)]
    run = make_multiseq_sequence_runner(cam, orb, MatcherConfig(), TrackerConfig(), device=dev,
                                        group=mesh.group)
    run(*args)  # warm-up
    times = []
    for _ in range(reps):
        dist.barrier()
        _sync(dev)
        t0 = time.perf_counter()
        run(*args)
        _sync(dev)
        times.append(time.perf_counter() - t0)
    dt = statistics.median(times)
    return {"bench": "multiseq_weak", "n": n, "ms_per_run": dt * 1e3,
            "ms_per_run_reps": [x * 1e3 for x in times], "aggregate_fps": B * frames / dt,
            "frames": frames}


def _rank(mesh, n_points: int, frames: int, reps: int, multiseq: bool) -> list:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if mesh.device.type == "cpu":  # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // mesh.size))
    out = [_ba_strong(mesh, n_points, reps)]
    if multiseq:
        out.append(_multiseq_weak(mesh, frames, reps))
    return out


def plan(n: int, cpu: bool, cards: int, shared_card: bool) -> dict:
    """How N ranks run: ``backend``, ``cards``, ``ranks_per_card``, and
    ``not_run`` where they do not."""
    if cpu:
        return {"backend": "gloo", "cards": 0, "ranks_per_card": None, "device": "cpu"}
    if n <= cards:
        return {"backend": "nccl", "cards": n, "ranks_per_card": 1, "device": "cuda"}
    if shared_card and cards:
        return {"backend": "gloo", "cards": cards, "ranks_per_card": -(-n // cards),
                "device": "cuda", "shared_card": True}
    return {"backend": None, "cards": cards, "ranks_per_card": None,
            "not_run": f"{cards} card" + ("" if cards == 1 else "s")}


def measure(ns, cpu: bool = False, shared_card: bool = False, n_points: int = NPTS,
            frames: int = MS_FRAMES, reps: int = REPS, multiseq: bool = True,
            say=print) -> dict:
    """Both measurements at each N of ``ns``; returns the JSON record."""
    cards = 0 if cpu else torch.cuda.device_count()
    if not cpu and not cards:
        raise RuntimeError("no CUDA device: pass --cpu to run gloo ranks on the CPU")
    device = "cpu" if cpu else card("cuda:0")
    results = []
    for n in ns:
        how = plan(n, cpu, cards, shared_card)
        if "not_run" in how:
            rows = [{"bench": b, "n": n, **how, "device": device}
                    for b in ("ba_strong", "multiseq_weak")[:1 + multiseq]]
        else:
            say(f"[scaling] n={n} ({how['backend']}, {how['cards']} cards) ...")
            t0 = time.perf_counter()
            ranks = spawn(_rank, n, how["backend"], how["device"],
                          (n_points, frames, reps, multiseq), timeout=3000)
            # every rank times the same collective program: rank 0's numbers
            rows = [{**rec, **{k: v for k, v in how.items() if k != "device"},
                     "device": device} for rec in ranks[0]]
            for rec in rows:
                if rec["bench"] == "ba_strong":
                    rec["final_cost_by_rank"] = [r[0]["final_cost"] for r in ranks]
            say(f"[scaling] n={n}: {time.perf_counter() - t0:.1f} s with the spawn")
        for rec in rows:
            say(json.dumps(rec))
        results.extend(rows)
    ba = [r for r in results if r["bench"] == "ba_strong" and "ms_per_solve" in r]
    return {"results": results,
            "psum_payload_bytes": ba[0]["psum_payload_bytes"] if ba else None,
            "psum_payload_bytes_formula": allreduce_bytes_per_iteration(NKF, NKF),
            "device": device}


def _summary(rec: dict, say=print) -> None:
    ba = {r["n"]: r for r in rec["results"] if r["bench"] == "ba_strong" and "ms_per_solve" in r}
    ms = {r["n"]: r for r in rec["results"]
          if r["bench"] == "multiseq_weak" and "ms_per_run" in r}
    say(f"== strong scaling: point-sharded Schur BA ({NKF} keyframes, 10 LM iterations), "
        f"{rec['device']} ==")
    for n, r in sorted(ba.items()):
        sp = ba[min(ba)]["ms_per_solve"] / r["ms_per_solve"]
        say(f"  N={n} ({r['backend']}, {r['ranks_per_card']} a card): {r['ms_per_solve']:.1f} "
            f"ms/solve, speedup {sp:.2f}x, cost {r['final_cost']!r}, all-reduce "
            f"{r['psum_payload_bytes']} B a iteration in {r['collective_ms_per_iter']:.3f} ms")
    say("== weak scaling: DP sequence runner, B = N ==")
    for n, r in sorted(ms.items()):
        say(f"  N={n} ({r['backend']}): {r['ms_per_run']:.1f} ms/run, aggregate "
            f"{r['aggregate_fps']:.2f} frames/s")
    for r in rec["results"]:
        if "not_run" in r:
            say(f"  {r['bench']} N={r['n']}: not run, {r['not_run']}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cpu", action="store_true", help="gloo ranks on the CPU")
    ap.add_argument("--shared-card", action="store_true",
                    help="run N above the card count as gloo ranks sharing the cards")
    ap.add_argument("--skip-multiseq", action="store_true")
    ap.add_argument("--json", default=None)
    a = ap.parse_args(argv)
    rec = measure(NS, a.cpu, a.shared_card, multiseq=not a.skip_multiseq)
    _summary(rec)
    if a.json:
        with open(a.json, "w") as f:
            json.dump(rec, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
