"""Plain localization against a frozen map: the yardstick's frozen copy of
the two-stage tracking step and its constant-velocity carry.

Per frame of every stream, in float32 plain PyTorch: ORB extraction
(``orb.Extractor``), the map projected under the predicted pose and
matched in a window round each projection (the least Hamming distance
among the keypoints within the radius, scaled by the keypoint's octave,
at most ``th_high``; one map point per keypoint, the nearer and then the
lower point index winning), the pose-only Levenberg-Marquardt with Huber
weights and reclassification rounds, a tight re-match from the refined
pose and the LM again (ORB-SLAM2's TrackWithMotionModel). The map has no
viewing statistics, so the frustum's distance and angle gates are off, as
for a map that localization mode freezes without them. The Hamming
minimum goes through the dense [P, N] distance matrix, streams in blocks,
so nothing here needs a kernel of its own.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from .orb import Extractor, Keypoints, OrbParams

__all__ = ["TrackParams", "localize", "step", "carry", "hat", "se3_exp", "inv3x3", "nielsen_update",
           "huber_weight"]

CHI2 = 5.991
BIG = 1 << 20
INT_MAX = torch.iinfo(torch.int32).max


class TrackParams(NamedTuple):
    projection_radius: float  # stage-1 window, px at octave 0
    local_map_radius: float   # stage-2 window
    pose_opt_rounds: int
    pose_opt_iters: int
    th_high: int


def hat(w: torch.Tensor) -> torch.Tensor:
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([torch.stack([z, -wz, wy], -1), torch.stack([wz, z, -wx], -1),
                        torch.stack([-wy, wx, z], -1)], -2)


def se3_exp(xi: torch.Tensor):
    """Tangent (omega, v) [..., 6] -> (R, t); Taylor-guarded below 1e-8."""
    omega, v = xi[..., :3], xi[..., 3:]
    th2 = (omega * omega).sum(dim=-1)
    th = torch.sqrt(th2 + 1e-8)
    small = th2 < 1e-8
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / (th2 + 1e-8))
    c = torch.where(small, 1.0 / 6.0 - th2 / 120.0, (th - torch.sin(th)) / (th2 * th + 1e-8))
    K = hat(omega)
    eye = torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)
    KK = K @ K
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return R, (V @ v[..., None])[..., 0]


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, -(d * i - f * g), d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1)], dim=-2)
    return adj / det[..., None, None]


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    return torch.where(chi2 <= delta2, 1.0, torch.sqrt(delta2 / chi2.clamp_min(1e-20)))


def nielsen_update(lam, nu, rho):
    good = rho > 0
    factor = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    return (torch.where(good, lam * factor, lam * nu),
            torch.where(good, torch.full_like(nu, 2.0), nu * 2.0))


def _solve6(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Symmetric positive-definite 6x6 systems by 3x3 block elimination."""
    A, Bm, D = H[..., :3, :3], H[..., :3, 3:], H[..., 3:, 3:]
    Ai = inv3x3(A)
    AiB = Ai @ Bm
    Si = inv3x3(D - Bm.transpose(-1, -2) @ AiB)
    Aib1 = torch.einsum("...ij,...j->...i", Ai, b[..., :3])
    x2 = torch.einsum("...ij,...j->...i", Si,
                      b[..., 3:] - torch.einsum("...ji,...j->...i", Bm, Aib1))
    x1 = Aib1 - torch.einsum("...ij,...j->...i", AiB, x2)
    return torch.cat([x1, x2], dim=-1)


def _residuals(R, t, pts, uv, fx, fy, cx, cy):
    pc = pts @ R.transpose(-1, -2) + t[..., None, :]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    r = torch.stack([fx * x * zi + cx, fy * y * zi + cy], dim=-1) - uv
    zero = torch.zeros_like(x)
    Jp = torch.stack([torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1),
                      torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=pc.dtype, device=pc.device).expand(pc.shape[:-1] + (3, 3))
    return r, Jp @ torch.cat([-hat(pc), eye], dim=-1), z


def _cost(r, inv_s2, active, huber: bool, delta2: float):
    chi2 = (r * r).sum(dim=-1) * inv_s2
    rho = torch.where(chi2 <= delta2, chi2, 2.0 * torch.sqrt(delta2 * chi2) - delta2) \
        if huber else chi2
    return torch.where(active, rho, 0.0).sum(dim=-1)


def optimize_pose(R, t, pts, uv, inv_s2, valid, K, rounds: int, iters: int):
    """Batched [B] pose LM: ``rounds`` reclassification rounds of ``iters``
    damped Gauss-Newton steps, the first with the Huber threshold x25,
    the first two robust; -> (R, t, n_inliers)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    inl = valid
    r, J, z = _residuals(R, t, pts, uv, fx, fy, cx, cy)
    for rnd in range(rounds):
        huber = rnd < 2
        delta2 = CHI2 * (25.0 if rnd == 0 else 1.0)
        lam = torch.full(R.shape[:-2], 1e-4, dtype=torch.float32, device=R.device)
        nu = torch.full(R.shape[:-2], 2.0, dtype=torch.float32, device=R.device)
        cost = _cost(r, inv_s2, inl, huber, delta2)
        for _ in range(iters):
            chi2 = (r * r).sum(dim=-1) * inv_s2
            w = huber_weight(chi2, delta2) if huber else torch.ones_like(chi2)
            w = torch.where(inl, w * inv_s2, 0.0)
            Jw = J * w[..., None, None]
            H = torch.einsum("...nri,...nrj->...ij", Jw, J)
            g = torch.einsum("...nri,...nr->...i", Jw, r)
            Hd = H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
            dx = _solve6(Hd, -g)
            dR, dt = se3_exp(dx)
            R_new = dR @ R
            t_new = (dR @ t[..., None])[..., 0] + dt
            r_new, J_new, z_new = _residuals(R_new, t_new, pts, uv, fx, fy, cx, cy)
            new_cost = _cost(r_new, inv_s2, inl, huber, delta2)
            step = lam[..., None] * torch.diagonal(H, dim1=-2, dim2=-1) * dx - g
            pred = 0.5 * (dx * step).sum(dim=-1)
            lam, nu = nielsen_update(lam, nu, (cost - new_cost) / pred.abs().clamp_min(1e-9))
            good = new_cost < cost
            g1, g2 = good[..., None], good[..., None, None]
            R, t = torch.where(g2, R_new, R), torch.where(g1, t_new, t)
            cost = torch.where(good, new_cost, cost)
            r, J = torch.where(g2, r_new, r), torch.where(g2[..., None], J_new, J)
            z = torch.where(g1, z_new, z)
        chi2 = (r * r).sum(dim=-1) * inv_s2
        inl = valid & (chi2 <= CHI2) & (z > 0)
    return R, t, inl.sum(dim=-1, dtype=torch.int32)


def _hamming(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[B, P, 8] x [B, N, 8] int32 -> [B, P, N] int32: pop(a) + pop(b) - 2
    <a, b> over the {0, 1} bit planes (every partial sum an integer <= 256,
    so the float32 product is exact in any order and at any precision)."""
    shifts = torch.arange(32, dtype=torch.int32, device=d1.device)

    def planes(d):
        return ((d[..., None] >> shifts) & 1).reshape(d.shape[:-1] + (256,)).to(torch.float32)

    a, b = planes(d1), planes(d2)
    inner = a @ b.transpose(-1, -2)
    return (a.sum(-1)[..., :, None] + b.sum(-1)[..., None, :] - 2.0 * inner).to(torch.int32)


def match(map_pts, map_desc, map_valid, R, t, K, kp: Keypoints, radius: float,
          th_high: int, width: int, height: int, scale_factor: float):
    """Projection matching of [B] streams: (kp_for_point [B, P] int32 or -1,
    n_matches [B])."""
    P, N = map_pts.shape[-2], kp.xy.shape[-2]
    pc = map_pts @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[0, 0] * pc[..., 0] * zi + K[0, 2]
    v = K[1, 1] * pc[..., 1] * zi + K[1, 2]
    vis = map_valid & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)
    r_kp = radius * scale_factor ** kp.octave.to(torch.float32)
    D = _hamming(map_desc, kp.desc)
    elig = (vis[..., :, None] & kp.valid[..., None, :]
            & ((u[..., :, None] - kp.xy[..., None, :, 0]).abs() <= r_kp[..., None, :])
            & ((v[..., :, None] - kp.xy[..., None, :, 1]).abs() <= r_kp[..., None, :]))
    best, best_j = torch.where(elig, D, BIG).min(dim=-1)
    accept = (best <= th_high) & vis
    rows = torch.arange(P, dtype=torch.int32, device=map_pts.device)
    key = torch.where(accept, best.to(torch.int32) * P + rows, INT_MAX)
    j = best_j.long()
    least = torch.full(key.shape[:-1] + (N,), INT_MAX, dtype=torch.int32, device=key.device)
    least.scatter_reduce_(-1, j, key, "amin")
    keep = accept & (key == least.gather(-1, j))
    return torch.where(keep, best_j.to(torch.int32), -1), keep.sum(dim=-1, dtype=torch.int32)


def step(extractor: Extractor, orb: OrbParams, tp: TrackParams, images: torch.Tensor,
         map_pts, map_desc, map_valid, R_prev, t_prev, R_pred, t_pred, K):
    """One frame of [B] streams: the two-stage step from the previous pose
    (``R_prev``, ``t_prev``, the optimiser's seed) and the predicted one
    (the stage-1 window's centre) -> (R, t, n_inliers, n_matches)."""
    h, w = images.shape[-2:]
    s = orb.scale_factor
    kp = extractor(images)

    def stage(R_at, t_at, R_seed, t_seed, rad):
        kfp, nm = match(map_pts, map_desc, map_valid, R_at, t_at, K, kp, rad, tp.th_high,
                        w, h, s)
        safe = kfp.clamp_min(0).long()
        uv = torch.take_along_dim(kp.xy, safe[..., None], dim=-2)
        inv_s2 = 1.0 / s ** (2.0 * kp.octave.gather(-1, safe).to(torch.float32))
        Rn, tn, ninl = optimize_pose(R_seed, t_seed, map_pts, uv, inv_s2, kfp >= 0, K,
                                     tp.pose_opt_rounds, tp.pose_opt_iters)
        return Rn, tn, ninl, nm

    R1, t1, _, _ = stage(R_pred, t_pred, R_prev, t_prev, tp.projection_radius)
    return stage(R1, t1, R1, t1, tp.local_map_radius)


def carry(R0, t0, R, t):
    """Per frame of [B, T] answers, the state the constant-velocity model
    gives the step: (R_prev, t_prev, R_pred, t_pred), each [B, T, ...];
    frame 0 starts from (R0, t0) with no velocity, frame 1 on takes the
    velocity between the two frames before it."""
    Rp = torch.cat([R0[:, None], R[:, :-1]], dim=1)
    tp = torch.cat([t0[:, None], t[:, :-1]], dim=1)
    Rpp = torch.cat([R0[:, None], Rp[:, :-1]], dim=1)
    tpp = torch.cat([t0[:, None], tp[:, :-1]], dim=1)
    vR = Rp @ Rpp.transpose(-1, -2)
    vt = tp - (vR @ tpp[..., None])[..., 0]
    R_pred = vR @ Rp
    t_pred = (vR @ tp[..., None])[..., 0] + vt
    R_pred[:, 0], t_pred[:, 0] = Rp[:, 0], tp[:, 0]
    return Rp, tp, R_pred, t_pred


def localize(extractor: Extractor, orb: OrbParams, tp: TrackParams, images: torch.Tensor,
             map_pts, map_desc, map_valid, R0, t0, K) -> Dict[str, torch.Tensor]:
    """T frames of B streams from (R0, t0) against their frozen maps, each
    frame predicted from the two before it: ``R [B, T, 3, 3]``, ``t [B, T,
    3]``, ``n_inliers [B, T]`` and ``n_matches [B, T]`` (the tight
    stage's)."""
    R, t, vel = R0, t0, None
    outs = []
    for f in range(images.shape[1]):
        if vel is None:
            Rp, tp_ = R, t
        else:
            Rp = vel[0] @ R
            tp_ = (vel[0] @ t[..., None])[..., 0] + vel[1]
        R2, t2, ninl, nm = step(extractor, orb, tp, images[:, f], map_pts, map_desc, map_valid,
                                R, t, Rp, tp_, K)
        vR = R2 @ R.transpose(-1, -2)
        vel = (vR, t2 - (vR @ t[..., None])[..., 0])
        R, t = R2, t2
        outs.append((R2, t2, ninl, nm))
    Rs, ts, ni, nm = (torch.stack(x, dim=1) for x in zip(*outs))
    return {"R": Rs, "t": ts, "n_inliers": ni, "n_matches": nm}
