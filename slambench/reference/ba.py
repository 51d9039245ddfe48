"""Plain global bundle adjustment: the yardstick's frozen copy of the
Schur-complement Levenberg-Marquardt over poses and points.

ORB-SLAM2's global BA in plain PyTorch: Huber-robust reprojection error
(chi2 threshold 5.991) of every observation, per camera 6x6 and per point
3x3 normal blocks and the camera-point coupling summed in a fixed order
(a stable sort of the index set, then ``segment_reduce``), multiplicative
damping on the block diagonals, the point blocks inverted in closed form
in float64, the reduced camera system by Cholesky, Nielsen's damping
schedule and the relative-cost early stop, which keeps the carry of a
step taken after convergence. It imports nothing of the program.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .track import hat, huber_weight, inv3x3, nielsen_update, se3_exp

__all__ = ["BAOut", "bundle_adjust"]

CHI2 = 5.991


class BAOut(NamedTuple):
    kf_R: torch.Tensor
    kf_t: torch.Tensor
    pts: torch.Tensor
    cost0: torch.Tensor
    cost: torch.Tensor


def _segments(idx: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None):
    key = idx.long() if valid is None else torch.where(valid, idx.long(), n)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    return order, torch.searchsorted(key[order], bounds)


def _segsum(vals: torch.Tensor, seg) -> torch.Tensor:
    order, offsets = seg
    return torch.segment_reduce(vals[order], "sum", offsets=offsets, axis=0, unsafe=True)


def _residuals(R, t, X, okf, opt, uv, fx, fy, cx, cy):
    Ro = R[okf]
    pc = (Ro @ X[opt][..., None])[..., 0] + t[okf]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    r = torch.stack([fx * x * zi + cx, fy * y * zi + cy], dim=-1) - uv
    zero = torch.zeros_like(x)
    Jp = torch.stack([torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1),
                      torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return r, Jp @ torch.cat([-hat(pc), eye], dim=-1), Jp @ Ro


def _rho(r, w):
    chi2 = (r * r).sum(dim=-1) * w
    return torch.where(chi2 <= CHI2, chi2, 2.0 * torch.sqrt(CHI2 * chi2) - CHI2)


def bundle_adjust(kf_R, kf_t, pts, obs_kf, obs_pt, obs_uv, obs_w, kf_fixed, K,
                  iterations: int, early_stop_rel: float) -> BAOut:
    """Every valid camera free but the ``kf_fixed`` ones; every point free;
    ``iterations`` gated LM steps."""
    dev, fdt = pts.device, pts.dtype
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    nK, nP = kf_R.shape[0], pts.shape[0]
    nF = nK
    okf, opt = obs_kf.long(), obs_pt.long()
    free = ~kf_fixed
    rank = torch.cumsum(free.to(torch.int64), 0) - 1
    fidx = torch.where(free, rank, nF)
    cell = opt * (nF + 1) + fidx[okf]
    seg_k, seg_p = _segments(okf, nK), _segments(opt, nP)
    seg_w, seg_f = _segments(cell, nP * (nF + 1)), _segments(fidx, nF + 1)
    eye3 = torch.eye(3, dtype=fdt, device=dev)
    eye6 = torch.eye(6, dtype=fdt, device=dev)
    eyeF = torch.eye(nF, dtype=fdt, device=dev)
    omask = (torch.arange(nF, device=dev) < free.sum()).to(fdt)
    empty = torch.einsum("k,km,ij->kimj", 1.0 - omask, eyeF, eye6)
    rank_safe = rank.clamp(0, nF - 1)

    def cost_of(R, t, X):
        return _rho(_residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)[0], obs_w).sum()

    def step(R, t, X, lam, nu, cost, done, rejects):
        r, Jc, Jp = _residuals(R, t, X, okf, opt, obs_uv, fx, fy, cx, cy)
        chi2 = (r * r).sum(dim=-1) * obs_w
        w = huber_weight(chi2, CHI2) * obs_w
        Jcw, Jpw = Jc * w[:, None, None], Jp * w[:, None, None]
        bU = Jcw[:, 0, :, None] * Jc[:, 0, None, :] + Jcw[:, 1, :, None] * Jc[:, 1, None, :]
        bV = Jpw[:, 0, :, None] * Jp[:, 0, None, :] + Jpw[:, 1, :, None] * Jp[:, 1, None, :]
        bgc = Jcw[:, 0] * r[:, 0, None] + Jcw[:, 1] * r[:, 1, None]
        bgp = Jpw[:, 0] * r[:, 0, None] + Jpw[:, 1] * r[:, 1, None]
        bW = Jcw[:, 0, :, None] * Jp[:, 0, None, :] + Jcw[:, 1, :, None] * Jp[:, 1, None, :]
        U, V = _segsum(bU, seg_k), _segsum(bV, seg_p)
        g_c, g_p = _segsum(bgc, seg_k), _segsum(bgp, seg_p)
        Wb = _segsum(bW, seg_w).view(nP, nF + 1, 6, 3)[:, :nF]
        Ud = U + lam * eye6 * torch.diagonal(U, dim1=-2, dim2=-1)[:, None, :]
        Vd = V + lam * eye3 * torch.diagonal(V, dim1=-2, dim2=-1)[:, None, :]
        Vinv = inv3x3(Vd.double()).to(fdt)
        Ud_free = _segsum(Ud, seg_f)[:nF]
        g_free = _segsum(torch.where(free[:, None], g_c, 0.0), seg_f)[:nF]
        Y = (Wb[..., 0:1] * Vinv[:, None, None, 0, :] + Wb[..., 1:2] * Vinv[:, None, None, 1, :]
             + Wb[..., 2:3] * Vinv[:, None, None, 2, :])
        S = torch.einsum("kij,km->kimj", Ud_free, eyeF) - torch.einsum("pkil,pmjl->kimj", Y, Wb)
        rhs = -g_free + torch.einsum("pkil,pl->ki", Y, g_p)
        S = S * omask[:, None, None, None] * omask[None, None, :, None] + empty
        rhs = rhs * omask[:, None]
        Sm = S.reshape(nF * 6, nF * 6) + 1e-8 * torch.eye(nF * 6, dtype=fdt, device=dev)
        L, info = torch.linalg.cholesky_ex(Sm)
        dxf = torch.cholesky_solve(rhs.reshape(-1, 1), L).reshape(nF, 6)
        dxf = torch.where(info == 0, dxf, float("nan"))
        dxc = torch.where(free[:, None], dxf[rank_safe], 0.0)
        gsum = g_p + torch.einsum("pkil,ki->pl", Wb, dxf)
        dxp = -(Vinv[:, :, 0] * gsum[:, 0:1] + Vinv[:, :, 1] * gsum[:, 1:2]
                + Vinv[:, :, 2] * gsum[:, 2:3])
        dR, dt = se3_exp(dxc)
        R_new = dR @ R
        t_new = (dR @ t[..., None])[..., 0] + dt
        X_new = X + dxp
        new_cost = cost_of(R_new, t_new, X_new)
        predc = 0.5 * (dxc * (lam * torch.diagonal(U, dim1=-2, dim2=-1) * dxc - g_c)).sum()
        predp = 0.5 * (dxp * (lam * torch.diagonal(V, dim1=-2, dim2=-1) * dxp - g_p)).sum()
        pred = (predc + predp).abs()
        lam_new, nu_new = nielsen_update(lam, nu, (cost - new_cost) / pred.clamp_min(1e-9))
        good = new_cost < cost
        rejects = torch.where(good, 0, rejects + 1)
        if early_stop_rel > 0.0:
            rel = early_stop_rel * cost.abs()
            done = (done | (good & ((cost - new_cost) <= rel)) | (~good & (pred <= rel))
                    | (rejects >= 10) | (lam_new > 1e8))
        return (torch.where(good, R_new, R), torch.where(good, t_new, t),
                torch.where(good, X_new, X), lam_new, nu_new,
                torch.where(good, new_cost, cost), done, rejects)

    cost0 = cost_of(kf_R, kf_t, pts)
    carry = (kf_R, kf_t, pts, torch.full((), 1e-4, dtype=fdt, device=dev),
             torch.full((), 2.0, dtype=fdt, device=dev), cost0,
             torch.zeros((), dtype=torch.bool, device=dev),
             torch.zeros((), dtype=torch.int32, device=dev))
    for _ in range(iterations):
        new = step(*carry)
        if early_stop_rel > 0.0:
            new = tuple(torch.where(carry[6], old, n) for old, n in zip(carry, new))
        carry = new
    return BAOut(carry[0], carry[1], carry[2], cost0, carry[5])
