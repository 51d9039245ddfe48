"""Pose-only LM over SE(3) with Huber weights and staged outlier
reclassification (counterpart of ``optim/pose_opt.py``).

Minimises the reprojection error of known map points over the camera pose
with analytic Jacobians of a left-multiplied se(3) increment, Huber kernel
at delta^2 = 5.991 (widened in the first round), ORB-SLAM's reclassify-
and-reoptimise rounds and Nielsen damping. Everything is f32 and
fixed-shape; the LM iterations are a Python loop of ``torch.where``
selects carrying the speculative-accept state, so nothing syncs the host.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from .lm import huber_weight, nielsen_update, solve_damped

__all__ = ["PoseOptResult", "optimize_pose"]

_CHI2_TH = 5.991  # 95% for 2 dof


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # [3, 3] optimised world-to-camera rotation
    t: torch.Tensor          # [3]
    inlier: torch.Tensor     # [N] bool final inlier classification
    n_inliers: torch.Tensor  # [] int32
    chi2: torch.Tensor       # [] final cost over inliers


def _residuals_jac(R, t, pts, uv, fx, fy, cx, cy):
    """Residuals [N, 2], Jacobians [N, 2, 6] w.r.t. xi = (omega, v) with
    T <- exp(xi) T, and depths [N]."""
    pc = pts @ R.T + t
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = fx * x * zi + cx
    v = fy * y * zi + cy
    r = torch.stack([u, v], dim=-1) - uv
    zero = torch.zeros_like(x)
    J_proj = torch.stack([
        torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1),
        torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1),
    ], dim=-2)                                               # [N, 2, 3]
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    J_pc = torch.cat([-se3.hat(pc), eye], dim=-1)            # [N, 3, 6]
    return r, J_proj @ J_pc, z


def _robust_cost(r, inv_sigma2, active, use_huber: bool, delta2: float):
    chi2 = (r * r).sum(dim=-1) * inv_sigma2
    if use_huber:
        rho = torch.where(chi2 <= delta2, chi2,
                          2.0 * torch.sqrt(delta2 * chi2) - delta2)
    else:
        rho = chi2
    return torch.where(active, rho, 0.0).sum()


def _lm_rounds(R, t, r, J, z, pts, uv, inv_sigma2, active, fx, fy, cx, cy,
               iters: int, use_huber: bool, delta_scale: float):
    """``iters`` LM steps over the active subset. The carry holds the
    linearisation at the accepted pose, so each step costs one
    residual+Jacobian pass at the candidate; a rejected step reuses the
    carried linearisation with a larger lambda."""
    delta2 = _CHI2_TH * delta_scale
    # device-side fills, not host->device copies: the step stays free of
    # host syncs
    lam = torch.full((), 1e-4, dtype=torch.float32, device=R.device)
    nu = torch.full((), 2.0, dtype=torch.float32, device=R.device)
    cost = _robust_cost(r, inv_sigma2, active, use_huber, delta2)
    for _ in range(iters):
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        w = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w = torch.where(active, w * inv_sigma2, 0.0)
        Jw = J * w[:, None, None]
        H = torch.einsum("nri,nrj->ij", Jw, J)
        b = torch.einsum("nri,nr->i", Jw, r)
        dx = solve_damped(H, -b, lam)
        dR, dt = se3.se3_exp(dx)
        R_new = dR @ R
        t_new = dR @ t + dt
        r_new, J_new, z_new = _residuals_jac(R_new, t_new, pts, uv,
                                             fx, fy, cx, cy)
        new_cost = _robust_cost(r_new, inv_sigma2, active, use_huber, delta2)
        # predicted decrease of the damped quadratic model (g2o's rho
        # denominator): 0.5 * dx^T (lam * D dx - b)
        pred = 0.5 * torch.dot(dx, lam * torch.diagonal(H) * dx - b)
        rho_gain = (cost - new_cost) / pred.abs().clamp_min(1e-9)
        lam, nu = nielsen_update(lam, nu, rho_gain)
        good = new_cost < cost
        R = torch.where(good, R_new, R)
        t = torch.where(good, t_new, t)
        cost = torch.where(good, new_cost, cost)
        r = torch.where(good, r_new, r)
        J = torch.where(good, J_new, J)
        z = torch.where(good, z_new, z)
    return R, t, cost, r, J, z


def optimize_pose(R0: torch.Tensor, t0: torch.Tensor, pts: torch.Tensor,
                  uv: torch.Tensor, inv_sigma2: torch.Tensor,
                  valid: torch.Tensor, K: torch.Tensor, rounds: int = 4,
                  iters_per_round: int = 10,
                  coarse_delta_scale: float = 25.0) -> PoseOptResult:
    """Optimise a world-to-camera pose against known 3-D points.

    R0, t0: initial pose; pts [N, 3] world points; uv [N, 2] observed
    undistorted pixels; inv_sigma2 [N] per-observation information; valid
    [N] mask; K [3, 3]. The first round runs with the Huber threshold
    widened by ``coarse_delta_scale``; rounds 3+ drop the robust kernel.
    """
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R, t = R0, t0
    inlier = valid
    r, J, z = _residuals_jac(R, t, pts, uv, fx, fy, cx, cy)
    for rnd in range(rounds):
        R, t, _, r, J, z = _lm_rounds(
            R, t, r, J, z, pts, uv, inv_sigma2, inlier, fx, fy, cx, cy,
            iters_per_round, use_huber=rnd < 2,
            delta_scale=coarse_delta_scale if rnd == 0 else 1.0)
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        inlier = valid & (chi2 <= _CHI2_TH) & (z > 0)
    chi2 = (r * r).sum(dim=-1) * inv_sigma2
    return PoseOptResult(
        R=R, t=t, inlier=inlier,
        n_inliers=inlier.sum(dtype=torch.int32),
        chi2=torch.where(inlier, chi2, 0.0).sum(),
    )
