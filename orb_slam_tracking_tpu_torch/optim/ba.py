"""Bundle adjustment with a dense-block Schur complement (counterpart of
``optim/ba.py``, the g2o ``BlockSolver_6_3`` role): joint LM over the
poses and points of fixed-capacity keyframe / point / observation arrays.

This is the JAX package's scatter formulation, the one its ``"auto"``
mode takes off the TPU:

- per-camera 6x6 ``U``, per-point 3x3 ``V``, the gradients and the
  camera-point coupling ``W`` accumulate over the COO observation list
  (the ``.at[].add`` segment sums) with ``optim.segment``'s sorted
  segment sums: each index set is sorted once per solve, and every sum
  gives the same bits on every run;
- ``W`` is held only over the FREE cameras, ``[P, nF, 6, 3]`` with ``nF``
  the BA window; fixed and out-of-window cameras scatter into one dump
  slot that is sliced off, so they never enter the Schur system;
- ``V^-1`` is the closed-form 3x3 adjugate inverse, formed in float64
  and rounded to the solve's dtype (an f32 adjugate loses about twice the
  bits that XLA's fused multiply-adds keep in JAX's, and on
  ill-conditioned problems that left the Schur system not positive
  definite where JAX's is); the reduced camera
  system is solved by ``cholesky_ex`` + ``cholesky_solve`` (a system that
  is not positive definite gives a non-finite step, which the cost test
  rejects, as JAX's NaN-filled factor does);
- every one of the ``iterations`` LM steps runs; the early-stop gate
  (JAX's ``lax.cond`` no-op) keeps the carry of a step taken after
  convergence, which gives the same result without a host sync.

Nothing here reads a value on the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from .lm import huber_weight, inv3x3, nielsen_update
from .segment import segment_sum, segments

__all__ = ["BAResult", "bundle_adjust", "lm_solver"]

_CHI2_MONO = 5.991


class BAResult(NamedTuple):
    kf_R: torch.Tensor        # [K, 3, 3] optimised poses
    kf_t: torch.Tensor        # [K, 3]
    pts: torch.Tensor         # [P, 3] optimised points
    cost0: torch.Tensor       # [] initial robust cost
    cost: torch.Tensor        # [] final robust cost
    obs_inlier: torch.Tensor  # [O] bool final chi2 classification


def _obs_residuals(kf_R, kf_t, pts, obs_kf, obs_pt, obs_uv, fx, fy, cx, cy):
    """Residuals [O, 2], camera Jacobians [O, 2, 6] (left-multiplied
    increment), point Jacobians [O, 2, 3], camera-frame depth [O]."""
    Ro = kf_R[obs_kf]
    pc = (Ro @ pts[obs_pt][..., None])[..., 0] + kf_t[obs_kf]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    r = torch.stack([u, v], dim=-1) - obs_uv
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1),
        torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1),
    ], dim=-2)                                                  # [O, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    J_pc_cam = torch.cat([-se3.hat(pc), eye], dim=-1)           # [O, 3, 6]
    return r, J_proj @ J_pc_cam, J_proj @ Ro, z


def bundle_adjust(
    kf_R: torch.Tensor, kf_t: torch.Tensor, pts: torch.Tensor,
    obs_kf: torch.Tensor, obs_pt: torch.Tensor, obs_uv: torch.Tensor,
    obs_inv_sigma2: torch.Tensor, obs_valid: torch.Tensor,
    kf_fixed: torch.Tensor, pt_valid: torch.Tensor, K: torch.Tensor,
    iterations: int = 10, max_free_cams: Optional[int] = None,
    early_stop_rel: float = 0.0,
) -> BAResult:
    """Joint pose + structure LM over the observation list.

    ``kf_fixed [K]``: cameras held fixed (the gauge anchor and the
    keyframes outside the window). ``max_free_cams``: the bound on free
    cameras (the BA window); free cameras beyond it are treated as fixed
    for this solve. ``None`` = all cameras. ``early_stop_rel > 0`` turns on
    the JAX package's convergence gate: an accepted step that improved the
    cost by at most that fraction, a rejected step whose predicted gain is
    that small, ten rejections in a row, or a damping past 1e8 ends the
    solve.
    """
    carry, step, finish = lm_solver(
        kf_R, kf_t, pts, obs_kf, obs_pt, obs_uv, obs_inv_sigma2, obs_valid,
        kf_fixed, pt_valid, K, max_free_cams, early_stop_rel)
    for _ in range(iterations):
        carry = step(carry)
    return finish(carry)


def lm_solver(kf_R, kf_t, pts, obs_kf, obs_pt, obs_uv, obs_inv_sigma2, obs_valid,
              kf_fixed, pt_valid, K, max_free_cams=None, early_stop_rel=0.0):
    """``bundle_adjust`` one step at a time: its first carry
    ``(R, t, X, lam, nu, cost, done, rejects)``, the gated LM step
    ``step(carry) -> carry`` and ``finish(carry) -> BAResult``."""
    dev, fdt = pts.device, pts.dtype
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    nK, nP = kf_R.shape[0], pts.shape[0]
    nF = nK if max_free_cams is None else min(max_free_cams, nK)
    okf, opt = obs_kf.long(), obs_pt.long()

    # compact free-camera index: free camera k -> its rank in [0, nF);
    # fixed and beyond-window cameras -> the dump slot nF
    free_cam = ~kf_fixed
    free_rank = torch.cumsum(free_cam.to(torch.int64), 0) - 1
    in_window = free_cam & (free_rank < nF)
    fidx = torch.where(in_window, free_rank, nF)
    obs_cell = opt * (nF + 1) + fidx[okf]
    # the index sets of the segment sums, fixed for the whole solve; an
    # invalid observation's terms are zero (its weight is) and left out
    seg_k, seg_p = segments(okf, nK, obs_valid), segments(opt, nP, obs_valid)
    seg_w, seg_f = segments(obs_cell, nP * (nF + 1), obs_valid), segments(fidx, nF + 1)
    w_info = torch.where(obs_valid, obs_inv_sigma2, 0.0)
    eye3 = torch.eye(3, dtype=fdt, device=dev)
    eye6 = torch.eye(6, dtype=fdt, device=dev)
    eyeF = torch.eye(nF, dtype=fdt, device=dev)
    occupied = torch.arange(nF, device=dev) < in_window.sum()
    omask = occupied.to(fdt)
    empty_diag = torch.einsum("k,km,ij->kimj", 1.0 - omask, eyeF, eye6)
    rank_safe = free_rank.clamp(0, nF - 1)

    def robust_cost(R, t, X):
        r, _, _, _ = _obs_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        chi2 = (r * r).sum(dim=-1) * w_info
        rho = torch.where(chi2 <= _CHI2_MONO, chi2,
                          2.0 * torch.sqrt(_CHI2_MONO * chi2) - _CHI2_MONO)
        return rho.sum()

    def lm_iter(R, t, X, lam, nu, cost, done, rejects):
        r, Jc, Jp, _ = _obs_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        chi2 = (r * r).sum(dim=-1) * w_info
        w = huber_weight(chi2, _CHI2_MONO) * w_info
        Jcw = Jc * w[:, None, None]
        Jpw = Jp * w[:, None, None]
        bU = Jcw[:, 0, :, None] * Jc[:, 0, None, :] + Jcw[:, 1, :, None] * Jc[:, 1, None, :]
        bV = Jpw[:, 0, :, None] * Jp[:, 0, None, :] + Jpw[:, 1, :, None] * Jp[:, 1, None, :]
        bgc = Jcw[:, 0] * r[:, 0, None] + Jcw[:, 1] * r[:, 1, None]
        bgp = Jpw[:, 0] * r[:, 0, None] + Jpw[:, 1] * r[:, 1, None]
        bW = Jcw[:, 0, :, None] * Jp[:, 0, None, :] + Jcw[:, 1, :, None] * Jp[:, 1, None, :]
        U = segment_sum(bU, seg_k)
        V = segment_sum(bV, seg_p)
        g_c = segment_sum(bgc, seg_k)
        g_p = segment_sum(bgp, seg_p)
        # coupling over the compact free-camera axis, +1 dump slot
        Wb = segment_sum(bW, seg_w).view(nP, nF + 1, 6, 3)[:, :nF]

        # damping, multiplicative on the block diagonals
        Ud = U + lam * eye6 * torch.diagonal(U, dim1=-2, dim2=-1)[:, None, :]
        Vd = V + lam * eye3 * torch.diagonal(V, dim1=-2, dim2=-1)[:, None, :]
        Vd = torch.where(pt_valid[:, None, None], Vd, eye3)  # invalid points stay invertible
        Vinv = inv3x3(Vd.double()).to(fdt)

        Ud_free = segment_sum(Ud, seg_f)[:nF]
        g_c_free = segment_sum(torch.where(in_window[:, None], g_c, 0.0), seg_f)[:nF]
        Y = (Wb[..., 0:1] * Vinv[:, None, None, 0, :]
             + Wb[..., 1:2] * Vinv[:, None, None, 1, :]
             + Wb[..., 2:3] * Vinv[:, None, None, 2, :])        # [P, nF, 6, 3]
        S = torch.einsum("kij,km->kimj", Ud_free, eyeF)
        S = S - torch.einsum("pkil,pmjl->kimj", Y, Wb)
        rhs = -g_c_free + torch.einsum("pkil,pl->ki", Y, g_p)  # [nF, 6]
        # empty compact slots (fewer free cameras than nF): identity blocks
        S = S * omask[:, None, None, None] * omask[None, None, :, None] + empty_diag
        rhs = rhs * omask[:, None]

        Sm = S.reshape(nF * 6, nF * 6) + 1e-8 * torch.eye(nF * 6, dtype=fdt, device=dev)
        L, info = torch.linalg.cholesky_ex(Sm)
        dxc_free = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(nF, 6)
        dxc_free = torch.where(info == 0, dxc_free, float("nan"))
        dxc = torch.where(in_window[:, None], dxc_free[rank_safe], 0.0)
        gsum = g_p + torch.einsum("pkil,ki->pl", Wb, dxc_free)
        dxp = -(Vinv[:, :, 0] * gsum[:, 0:1] + Vinv[:, :, 1] * gsum[:, 1:2]
                + Vinv[:, :, 2] * gsum[:, 2:3])
        dxp = torch.where(pt_valid[:, None], dxp, 0.0)

        dR, dt = se3.se3_exp(dxc)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + dxp
        new_cost = robust_cost(R_new, t_new, X_new)
        # predicted decrease 0.5 * dx^T (lam D dx - g) over both blocks
        predc = 0.5 * (dxc * (lam * torch.diagonal(U, dim1=-2, dim2=-1) * dxc - g_c)).sum()
        predp = 0.5 * (dxp * (lam * torch.diagonal(V, dim1=-2, dim2=-1) * dxp - g_p)).sum()
        pred = (predc + predp).abs()
        rho = (cost - new_cost) / pred.clamp_min(1e-9)
        lam_new, nu_new = nielsen_update(lam, nu, rho)
        good = new_cost < cost
        rejects = torch.where(good, 0, rejects + 1)
        if early_stop_rel > 0.0:
            rel = early_stop_rel * cost.abs()
            converged_acc = good & ((cost - new_cost) <= rel)
            converged_rej = ~good & (pred <= rel)
            done = done | converged_acc | converged_rej | (rejects >= 10) | (lam_new > 1e8)
        return (torch.where(good, R_new, R), torch.where(good, t_new, t),
                torch.where(good, X_new, X), lam_new, nu_new,
                torch.where(good, new_cost, cost), done, rejects)

    def step(carry):
        stepped = lm_iter(*carry)
        if early_stop_rel > 0.0:
            # a step after convergence is a no-op: keep the carry
            done = carry[6]
            stepped = tuple(torch.where(done, old, new) for old, new in zip(carry, stepped))
        return stepped

    def finish(carry):
        R, t, X, _, _, cost, _, _ = carry
        r, _, _, z = _obs_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        chi2 = (r * r).sum(dim=-1) * w_info
        obs_inlier = obs_valid & (chi2 <= _CHI2_MONO) & (z > 0)
        return BAResult(kf_R=R, kf_t=t, pts=X, cost0=cost0, cost=cost, obs_inlier=obs_inlier)

    cost0 = robust_cost(kf_R, kf_t, pts)
    carry = (kf_R, kf_t, pts, torch.full((), 1e-4, dtype=fdt, device=dev),
             torch.full((), 2.0, dtype=fdt, device=dev), cost0,
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    return carry, step, finish
