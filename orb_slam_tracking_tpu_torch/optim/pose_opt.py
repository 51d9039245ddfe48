"""Pose-only LM over SE(3) with Huber weights and staged outlier
reclassification (counterpart of ``optim/pose_opt.py``).

Minimises the reprojection error of known map points over the camera pose
with analytic Jacobians of a left-multiplied se(3) increment, Huber kernel
at delta^2 = 5.991 (widened in the first round), ORB-SLAM's reclassify-
and-reoptimise rounds and Nielsen damping. Everything is f32 and
fixed-shape; the LM iterations are a Python loop of ``torch.where``
selects carrying the speculative-accept state, so nothing syncs the host.

A leading batch axis on the pose and the observations (``R0 [B, 3, 3]``,
``pts [B, N, 3]``, ...; ``K`` shared) optimises B poses at once, each with
its own damping schedule, as the JAX function under ``vmap``: the
multi-sequence runners' form. Every reduction runs over the observation
axis only, so a batched pose sees the same sums as its unbatched call.

``optimize_pose`` runs the plain version, ``optimize_pose_reference``, on
CPU tensors; on CUDA tensors it launches the kernel ``csrc/pose_lm.cu``,
which runs the whole call, every round and iteration, over the valid rows
only, one thread block a pose, in one launch (it replaces no TPU kernel:
the JAX package's LM is plain XLA). The kernel's sums run in another order,
so its poses agree with the plain version's to float32 rounding, not bit
for bit. ``optimize_pose.launches`` counts its launches.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geometry import se3
from .lm import huber_weight, nielsen_update, solve_damped

__all__ = ["PoseOptResult", "optimize_pose", "optimize_pose_reference"]

_CHI2_TH = 5.991  # 95% for 2 dof


class PoseOptResult(NamedTuple):
    R: torch.Tensor          # [(B,) 3, 3] optimised world-to-camera rotation
    t: torch.Tensor          # [(B,) 3]
    inlier: torch.Tensor     # [(B,) N] bool final inlier classification
    n_inliers: torch.Tensor  # [(B,)] int32
    chi2: torch.Tensor       # [(B,)] final cost over inliers


def _residuals_jac(R, t, pts, uv, fx, fy, cx, cy):
    """Residuals [(B,) N, 2], Jacobians [(B,) N, 2, 6] w.r.t. xi = (omega, v)
    with T <- exp(xi) T, and depths [(B,) N]."""
    pc = pts @ R.transpose(-1, -2) + t[..., None, :]
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
    return torch.where(active, rho, 0.0).sum(dim=-1)


def _lm_rounds(R, t, r, J, z, pts, uv, inv_sigma2, active, fx, fy, cx, cy,
               iters: int, use_huber: bool, delta_scale: float, batched_solve: bool):
    """``iters`` LM steps over the active subset. The carry holds the
    linearisation at the accepted pose, so each step costs one
    residual+Jacobian pass at the candidate; a rejected step reuses the
    carried linearisation with a larger lambda."""
    delta2 = _CHI2_TH * delta_scale
    # device-side fills, not host->device copies: the step stays free of
    # host syncs
    lam = torch.full(R.shape[:-2], 1e-4, dtype=torch.float32, device=R.device)
    nu = torch.full(R.shape[:-2], 2.0, dtype=torch.float32, device=R.device)
    batch = R.dim() > 2
    cost = _robust_cost(r, inv_sigma2, active, use_huber, delta2)
    for _ in range(iters):
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        w = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
        w = torch.where(active, w * inv_sigma2, 0.0)
        Jw = J * w[..., None, None]
        H = torch.einsum("...nri,...nrj->...ij", Jw, J)
        b = torch.einsum("...nri,...nr->...i", Jw, r)
        dx = solve_damped(H, -b, lam, batched=batched_solve)
        dR, dt = se3.se3_exp(dx)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt if batch else dR @ t + dt
        r_new, J_new, z_new = _residuals_jac(R_new, t_new, pts, uv,
                                             fx, fy, cx, cy)
        new_cost = _robust_cost(r_new, inv_sigma2, active, use_huber, delta2)
        # predicted decrease of the damped quadratic model (g2o's rho
        # denominator): 0.5 * dx^T (lam * D dx - b)
        step = lam[..., None] * torch.diagonal(H, dim1=-2, dim2=-1) * dx - b
        pred = 0.5 * ((dx * step).sum(dim=-1) if batch else torch.dot(dx, step))
        rho_gain = (cost - new_cost) / pred.abs().clamp_min(1e-9)
        lam, nu = nielsen_update(lam, nu, rho_gain)
        good = new_cost < cost
        g1, g2 = good[..., None], good[..., None, None]
        R = torch.where(g2, R_new, R)
        t = torch.where(g1, t_new, t)
        cost = torch.where(good, new_cost, cost)
        r = torch.where(g2, r_new, r)
        J = torch.where(g2[..., None], J_new, J)
        z = torch.where(g1, z_new, z)
    return R, t, cost, r, J, z


def optimize_pose_reference(R0: torch.Tensor, t0: torch.Tensor, pts: torch.Tensor,
                            uv: torch.Tensor, inv_sigma2: torch.Tensor,
                            valid: torch.Tensor, K: torch.Tensor, rounds: int = 4,
                            iters_per_round: int = 10,
                            coarse_delta_scale: float = 25.0,
                            batched_solve: bool = False) -> PoseOptResult:
    """The plain version of ``optimize_pose`` (the same arguments and
    result): every LM iteration a chain of PyTorch ops over all N rows,
    masked, on any device."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    R, t = R0, t0
    inlier = valid
    r, J, z = _residuals_jac(R, t, pts, uv, fx, fy, cx, cy)
    for rnd in range(rounds):
        R, t, _, r, J, z = _lm_rounds(
            R, t, r, J, z, pts, uv, inv_sigma2, inlier, fx, fy, cx, cy,
            iters_per_round, use_huber=rnd < 2,
            delta_scale=coarse_delta_scale if rnd == 0 else 1.0, batched_solve=batched_solve)
        chi2 = (r * r).sum(dim=-1) * inv_sigma2
        inlier = valid & (chi2 <= _CHI2_TH) & (z > 0)
    chi2 = (r * r).sum(dim=-1) * inv_sigma2
    return PoseOptResult(
        R=R, t=t, inlier=inlier,
        n_inliers=inlier.sum(dim=-1, dtype=torch.int32),
        chi2=torch.where(inlier, chi2, 0.0).sum(dim=-1),
    )


def optimize_pose(R0: torch.Tensor, t0: torch.Tensor, pts: torch.Tensor,
                  uv: torch.Tensor, inv_sigma2: torch.Tensor,
                  valid: torch.Tensor, K: torch.Tensor, rounds: int = 4,
                  iters_per_round: int = 10,
                  coarse_delta_scale: float = 25.0,
                  batched_solve: bool = False) -> PoseOptResult:
    """Optimise a world-to-camera pose against known 3-D points.

    R0, t0: initial pose; pts [N, 3] world points; uv [N, 2] observed
    undistorted pixels; inv_sigma2 [N] per-observation information; valid
    [N] mask; K [3, 3]. The first round runs with the Huber threshold
    widened by ``coarse_delta_scale``; rounds 3+ drop the robust kernel.
    A leading [B] on everything but K (and optionally pts, then shared)
    optimises B poses at once. ``batched_solve`` takes the 6x6 steps by the
    closed form ``solve_spd6`` in place of LU (the JAX package's switch;
    its multi-sequence runners set it, batched or not).

    CPU tensors run ``optimize_pose_reference``; CUDA tensors launch the
    kernel, float32 throughout, one launch a call.
    """
    args = (R0, t0, pts, uv, inv_sigma2, valid, K)
    if all(x.device.type == "cpu" for x in args):
        return optimize_pose_reference(*args, rounds=rounds, iters_per_round=iters_per_round,
                                       coarse_delta_scale=coarse_delta_scale,
                                       batched_solve=batched_solve)
    name = "optimize_pose"
    lead = tuple(R0.shape[:-2])
    if len(lead) > 1:
        raise ValueError(f"{name}: expected R0 [3, 3] or [B, 3, 3], got {tuple(R0.shape)}")
    n = uv.shape[-2]
    R0, t0, pts, uv, inv_sigma2, valid, K = (x.contiguous() for x in args)
    specs = ((R0, torch.float32, lead + (3, 3)), (t0, torch.float32, lead + (3,)),
             (pts, torch.float32, (lead if pts.dim() == 3 else ()) + (n, 3)),
             (uv, torch.float32, lead + (n, 2)), (inv_sigma2, torch.float32, lead + (n,)),
             (valid, torch.bool, lead + (n,)), (K, torch.float32, (3, 3)))
    for x, dtype, shape in specs:
        kernels.require_cuda(name, x, dtype, len(shape))
        if tuple(x.shape) != shape or x.device != R0.device:
            raise ValueError(f"{name}: expected shape {shape} on {R0.device}, got "
                             f"{tuple(x.shape)} on {x.device}")
    batch = lead[0] if lead else 1
    dev = R0.device
    R = torch.empty(lead + (3, 3), dtype=torch.float32, device=dev)
    t = torch.empty(lead + (3,), dtype=torch.float32, device=dev)
    inlier = torch.empty(lead + (n,), dtype=torch.bool, device=dev)
    n_inliers = torch.empty(lead, dtype=torch.int32, device=dev)
    chi2 = torch.empty(lead, dtype=torch.float32, device=dev)
    if batch == 0:
        return PoseOptResult(R=R, t=t, inlier=inlier, n_inliers=n_inliers, chi2=chi2)
    rows = torch.empty((batch, n), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = kernels.library().osltt_pose_lm(
            R0.data_ptr(), t0.data_ptr(), pts.data_ptr(), int(pts.dim() == 3),
            uv.data_ptr(), inv_sigma2.data_ptr(), valid.data_ptr(), K.data_ptr(), batch, n,
            rounds, iters_per_round, _CHI2_TH * coarse_delta_scale, int(batched_solve),
            rows.data_ptr(), R.data_ptr(), t.data_ptr(), inlier.data_ptr(),
            n_inliers.data_ptr(), chi2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    kernels.check_launch(name, rc)
    optimize_pose.launches += 1
    return PoseOptResult(R=R, t=t, inlier=inlier, n_inliers=n_inliers, chi2=chi2)


optimize_pose.launches = 0
