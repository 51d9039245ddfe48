"""Distributed bundle adjustment: the Schur reduction over point-sharded
observation blocks, with ``torch.distributed`` collectives (counterpart of
``parallel/ba_sharded.py``).

The map points and their observations are sharded over the ranks of a
process group; the cameras are replicated. Per LM iteration each rank
builds its camera and point blocks from its own observations (the sorted
segment sums of ``optim/segment.py``, so a rank repeats bit for bit),
inverts its point blocks (``optim.lm.inv3x3`` formed in float64, as
``optim/ba.py``) and reduces its Schur contribution ``S_local = -sum_p
W_p V_p^-1 W_p^T``; one ``all_reduce`` of one buffer then sums ``U``, the
camera gradient, ``S`` and the right-hand side over the ranks (four
psums in the JAX module; packing them changes no element's sum). The
camera solve (``cholesky_ex`` + ``cholesky_solve``, no host sync) is
replicated, the point back-substitution stays on each rank, and a second
``all_reduce`` sums the new robust cost and the points' predicted gain.

This is the JAX module's scatter branch, the one its ``"auto"`` takes off
the TPU. Cameras beyond ``max_free_cams`` are held fixed, as in
``optim.ba.bundle_adjust`` and as the JAX docstring states (JAX's sharded
program ties them to the window's last slot instead, ROADMAP C13). Inputs
are pre-bucketed so each observation lies on its point's rank
(``bucket_observations``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..geometry import se3
from ..optim.ba import normal_blocks, obs_residuals, robust_rho
from ..optim.lm import inv3x3, nielsen_update
from ..optim.segment import segment_sum, segments
from .distributed import group_rank_size

__all__ = ["bucket_observations", "bundle_adjust_sharded"]


def bucket_observations(obs_kf, obs_pt, obs_uv, obs_inv_sigma2, obs_valid,
                        n_points: int, n_devices: int, obs_per_shard: int):
    """Host-side: partition the points into contiguous shards and bucket
    each valid observation onto its point's shard, padding every shard to
    ``obs_per_shard`` (observations past it are dropped). Returns arrays
    of ``[n_devices * obs_per_shard, ...]`` with the point indices local to
    their shard (JAX's function, numpy)."""
    if n_points % n_devices:
        raise ValueError(f"{n_points} points do not divide over {n_devices} shards")
    per = n_points // n_devices
    okf, opt, ouv, ow, ov = (np.asarray(a) for a in (obs_kf, obs_pt, obs_uv, obs_inv_sigma2,
                                                     obs_valid))
    out_kf = np.zeros((n_devices, obs_per_shard), np.int32)
    out_pt = np.zeros((n_devices, obs_per_shard), np.int32)
    out_uv = np.zeros((n_devices, obs_per_shard, 2), np.float32)
    out_w = np.ones((n_devices, obs_per_shard), np.float32)
    out_v = np.zeros((n_devices, obs_per_shard), bool)
    for d in range(n_devices):
        idx = np.where(ov & (opt >= d * per) & (opt < (d + 1) * per))[0][:obs_per_shard]
        n = len(idx)
        out_kf[d, :n] = okf[idx]
        out_pt[d, :n] = opt[idx] - d * per
        out_uv[d, :n] = ouv[idx]
        out_w[d, :n] = ow[idx]
        out_v[d, :n] = True

    def flat(a):
        return a.reshape((n_devices * obs_per_shard,) + a.shape[2:])

    return flat(out_kf), flat(out_pt), flat(out_uv), flat(out_w), flat(out_v)


def bundle_adjust_sharded(
    kf_R: torch.Tensor, kf_t: torch.Tensor, pts: torch.Tensor,
    obs_kf: torch.Tensor, obs_pt: torch.Tensor, obs_uv: torch.Tensor,
    obs_inv_sigma2: torch.Tensor, obs_valid: torch.Tensor,
    kf_fixed: torch.Tensor, pt_valid: torch.Tensor, K: torch.Tensor,
    iterations: int = 10, max_free_cams: Optional[int] = None,
    segment_mode: str = "auto", group: Optional[dist.ProcessGroup] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Distributed LM BA over ``group`` (None = the default group). Returns
    (kf_R, kf_t, pts, final_cost).

    ``pts [P/D, 3]`` and ``pt_valid`` are this rank's contiguous shard of
    the points; ``obs_*`` its bucket of observations, their point indices
    local to the shard; ``kf_R [K, 3, 3]``, ``kf_t``, ``kf_fixed`` and
    ``K`` are replicated. The returned cameras and cost are the same on
    every rank, the points are the rank's shard. ``max_free_cams`` bounds
    the free cameras (the window; the all-reduced ``S`` shrinks with it).
    ``segment_mode``: ``"scatter"`` or ``"auto"`` (the same); the TPU
    forms are not ported and raise. ``iterations`` LM steps with the
    Nielsen damping update, a step kept only when it lowers the cost."""
    if segment_mode not in ("auto", "scatter"):
        raise ValueError(f"segment_mode {segment_mode!r}: only the scatter form is ported")
    group_rank_size(group, pts.device)
    dev, fdt = pts.device, pts.dtype
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    nK, nP = kf_R.shape[0], pts.shape[0]
    nF = nK if max_free_cams is None else min(max_free_cams, nK)
    okf, opt = obs_kf.long(), obs_pt.long()

    # compact free-camera index (replicated): free camera k -> its rank in
    # [0, nF); fixed and beyond-window cameras -> the dump slot nF
    free_cam = ~kf_fixed
    free_rank = torch.cumsum(free_cam.to(torch.int64), 0) - 1
    in_window = free_cam & (free_rank < nF)
    fidx = torch.where(in_window, free_rank, nF)
    seg_k, seg_p = segments(okf, nK, obs_valid), segments(opt, nP, obs_valid)
    seg_w = segments(opt * (nF + 1) + fidx[okf], nP * (nF + 1), obs_valid)
    seg_f = segments(fidx, nF + 1)
    w_info = torch.where(obs_valid, obs_inv_sigma2, 0.0)
    eye3 = torch.eye(3, dtype=fdt, device=dev)
    eye6 = torch.eye(6, dtype=fdt, device=dev)
    eyeF = torch.eye(nF, dtype=fdt, device=dev)
    omask = (torch.arange(nF, device=dev) < in_window.sum()).to(fdt)
    empty_diag = torch.einsum("k,km,ij->kimj", 1.0 - omask, eyeF, eye6)
    rank_safe = free_rank.clamp(0, nF - 1)
    sizes = (nK * 36, nK * 6, nF * 36 * nF, nF * 6)

    def local_cost(R, t, X):
        r, _, _, _ = obs_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        return robust_rho(r, w_info).sum()

    def step(R, t, X, lam, nu, cost):
        r, Jc, Jp, _ = obs_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        bU, bV, bgc, bgp, bW = normal_blocks(r, Jc, Jp, w_info)
        V = segment_sum(bV, seg_p)
        g_p = segment_sum(bgp, seg_p)
        Wb = segment_sum(bW, seg_w).view(nP, nF + 1, 6, 3)[:, :nF]
        Vd = V + lam * eye3 * torch.diagonal(V, dim1=-2, dim2=-1)[:, None, :]
        Vd = torch.where(pt_valid[:, None, None], Vd, eye3)
        Vinv = inv3x3(Vd.double()).to(fdt)
        Y = (Wb[..., 0:1] * Vinv[:, None, None, 0, :]
             + Wb[..., 1:2] * Vinv[:, None, None, 1, :]
             + Wb[..., 2:3] * Vinv[:, None, None, 2, :])        # [P/D, nF, 6, 3]
        # the only reductions over ranks: camera-sized, in one buffer
        packed = torch.cat([segment_sum(bU, seg_k).reshape(-1), segment_sum(bgc, seg_k).reshape(-1),
                            -torch.einsum("pkil,pmjl->kimj", Y, Wb).reshape(-1),
                            torch.einsum("pkil,pl->ki", Y, g_p).reshape(-1)])
        dist.all_reduce(packed, group=group)
        U, g_c, S, rhs = torch.split(packed, sizes)
        U, g_c = U.view(nK, 6, 6), g_c.view(nK, 6)
        S, rhs = S.view(nF, 6, nF, 6), rhs.view(nF, 6)

        Ud = U + lam * eye6 * torch.diagonal(U, dim1=-2, dim2=-1)[:, None, :]
        Ud_free = segment_sum(Ud, seg_f)[:nF]
        g_c_free = segment_sum(torch.where(in_window[:, None], g_c, 0.0), seg_f)[:nF]
        S = S + torch.einsum("kij,km->kimj", Ud_free, eyeF)
        rhs = rhs - g_c_free
        S = S * omask[:, None, None, None] * omask[None, None, :, None] + empty_diag
        rhs = rhs * omask[:, None]
        Sm = S.reshape(nF * 6, nF * 6) + 1e-8 * torch.eye(nF * 6, dtype=fdt, device=dev)
        L, info = torch.linalg.cholesky_ex(Sm)
        dxc_free = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(nF, 6)
        dxc_free = torch.where(info == 0, dxc_free, float("nan"))
        dxc = torch.where(in_window[:, None], dxc_free[rank_safe], 0.0)
        # this rank's point back-substitution
        gsum = g_p + torch.einsum("pkil,ki->pl", Wb, dxc_free)
        dxp = -(Vinv[:, :, 0] * gsum[:, 0:1] + Vinv[:, :, 1] * gsum[:, 1:2]
                + Vinv[:, :, 2] * gsum[:, 2:3])
        dxp = torch.where(pt_valid[:, None], dxp, 0.0)

        dR, dt = se3.se3_exp(dxc)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + dxp
        predc = 0.5 * (dxc * (lam * torch.diagonal(U, dim1=-2, dim2=-1) * dxc - g_c)).sum()
        summed = torch.stack([
            local_cost(R_new, t_new, X_new),
            0.5 * (dxp * (lam * torch.diagonal(V, dim1=-2, dim2=-1) * dxp - g_p)).sum()])
        dist.all_reduce(summed, group=group)
        new_cost, predp = summed[0], summed[1]
        rho = (cost - new_cost) / (predc + predp).abs().clamp_min(1e-9)
        lam_new, nu_new = nielsen_update(lam, nu, rho)
        good = new_cost < cost
        return (torch.where(good, R_new, R), torch.where(good, t_new, t),
                torch.where(good, X_new, X), lam_new, nu_new, torch.where(good, new_cost, cost))

    cost0 = local_cost(kf_R, kf_t, pts)
    dist.all_reduce(cost0, group=group)
    carry = (kf_R, kf_t, pts, torch.full((), 1e-4, dtype=fdt, device=dev),
             torch.full((), 2.0, dtype=fdt, device=dev), cost0)
    for _ in range(iterations):
        carry = step(*carry)
    R, t, X, _, _, cost = carry
    return R, t, X, cost
