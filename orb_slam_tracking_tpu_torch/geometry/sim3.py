"""Sim(3): similarity transforms for loop correction (counterpart of
``geometry/sim3.py``).

``(s, R, t)`` acts as ``X -> s R X + t``; the tangent is ``xi = [rho(3),
phi(3), sigma]`` with left-multiplied increments, as in ``geometry/se3.py``.
``sim3_exp`` / ``sim3_log`` are g2o's closed forms with the four
small-parameter regimes of the translation mixer selected branch-free;
``solve_sim3_horn`` is the weighted Horn / Umeyama solve, ``ransac_sim3``
its RANSAC over 3-point sets (the uniforms are an argument, as for
``ransac_pnp``), and ``optimize_sim3`` the robust LM on bidirectional
reprojection residuals (``Optimizer::OptimizeSim3``).

Everything is f32 on the tensors' device, with TF32 off (``device.full_f32``).
Solves take ``solve_ex``, which does not check for errors and so does not
read on the host; the Horn solve's SVD does (PyTorch checks its
convergence), once per call.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from .sampling import sample_distinct
from .se3 import hat, so3_exp, so3_log

__all__ = ["Sim3", "Sim3RansacResult", "sim3_exp", "sim3_log", "sim3_apply", "sim3_inverse",
           "sim3_compose", "solve_sim3_horn", "ransac_sim3", "optimize_sim3"]

_EPS = 1e-8
# the Huber threshold and inlier gate of optimize_sim3's chi2 (px^2)
HUBER_CHI2 = 10.0


class Sim3(NamedTuple):
    s: torch.Tensor  # [...] scale
    R: torch.Tensor  # [..., 3, 3]
    t: torch.Tensor  # [..., 3]


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M [..., 3, 3] @ v [..., 3]``."""
    return (M @ v[..., None])[..., 0]


def sim3_apply(g: Sim3, X: torch.Tensor) -> torch.Tensor:
    """``X [..., N, 3] -> s R X + t`` (a batch of transforms broadcasts
    against one point set)."""
    return g.s[..., None, None] * (X @ g.R.transpose(-1, -2)) + g.t[..., None, :]


def sim3_inverse(g: Sim3) -> Sim3:
    si = 1.0 / g.s
    Rt = g.R.transpose(-1, -2)
    return Sim3(s=si, R=Rt, t=-si[..., None] * _mv(Rt, g.t))


def sim3_compose(a: Sim3, b: Sim3) -> Sim3:
    """a o b (apply b first)."""
    return Sim3(s=a.s * b.s, R=a.R @ b.R, t=a.s[..., None] * _mv(a.R, b.t) + a.t)


def _w_matrix(phi: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The exponential's translation mixer ``W = C I + a1 hat(phi) + a2
    hat(phi)^2`` (``g2o/sim3.h:90-150``), with C = (e^s - 1)/s and a1, a2
    from the scalar integrals I_s, I_c; the regimes sigma -> 0, theta -> 0
    and both are selected by ``where`` on guarded operands."""
    theta = torch.linalg.vector_norm(phi, dim=-1)
    small_s = sigma.abs() < 1e-5
    small_t = theta < 1e-5
    s2 = torch.where(small_s, 1.0, sigma)
    t2 = torch.where(small_t, 1.0, theta)
    es = torch.exp(sigma)
    c = torch.cos(theta)
    sn = torch.sin(theta)
    denom = s2 * s2 + t2 * t2

    C = torch.where(small_s, 1.0 + sigma / 2.0, (es - 1.0) / s2)

    a1_gen = (es * (s2 * sn - t2 * c) + t2) / (t2 * denom)
    a1_s0 = (1.0 - c) / (t2 * t2)
    a1_t0 = (es * (s2 - 1.0) + 1.0) / (s2 * s2)
    a1_00 = torch.full_like(theta, 0.5)
    a1 = torch.where(small_t, torch.where(small_s, a1_00, a1_t0),
                     torch.where(small_s, a1_s0, a1_gen))

    I_c = (es * (s2 * c + t2 * sn) - s2) / denom
    a2_gen = (C - I_c) / (t2 * t2)
    a2_s0 = (t2 - sn) / (t2 * t2 * t2)
    a2_t0 = (es * (s2 * s2 / 2.0 - s2 + 1.0) - 1.0) / (s2 * s2 * s2)
    a2_00 = torch.full_like(theta, 1.0 / 6.0)
    a2 = torch.where(small_t, torch.where(small_s, a2_00, a2_t0),
                     torch.where(small_s, a2_s0, a2_gen))

    Phi = hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return (C[..., None, None] * eye + a1[..., None, None] * Phi
            + a2[..., None, None] * (Phi @ Phi))


def sim3_exp(xi: torch.Tensor) -> Sim3:
    """``xi [..., 7] = [rho, phi, sigma]`` -> Sim3."""
    rho, phi, sigma = xi[..., 0:3], xi[..., 3:6], xi[..., 6]
    return Sim3(s=torch.exp(sigma), R=so3_exp(phi), t=_mv(_w_matrix(phi, sigma), rho))


def sim3_log(g: Sim3) -> torch.Tensor:
    """Inverse of ``sim3_exp``: Sim3 -> ``xi [..., 7]``."""
    phi = so3_log(g.R)
    sigma = torch.log(g.s)
    W = _w_matrix(phi, sigma)
    rho = torch.linalg.solve_ex(W, g.t[..., None])[0][..., 0]
    return torch.cat([rho, phi, sigma[..., None]], dim=-1)


def solve_sim3_horn(x1: torch.Tensor, x2: torch.Tensor,
                    w: torch.Tensor | None = None) -> Sim3:
    """Closed-form weighted Horn / Umeyama: the Sim3 g with ``x1 ~ g(x2)``.
    ``x1, x2 [..., N, 3]``, optional weights ``w [..., N]``."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    wn = w / torch.clamp_min(w.sum(dim=-1, keepdim=True), _EPS)
    mu1 = (wn[..., :, None] * x1).sum(dim=-2)
    mu2 = (wn[..., :, None] * x2).sum(dim=-2)
    c1 = x1 - mu1[..., None, :]
    c2 = x2 - mu2[..., None, :]
    Sigma = (wn[..., :, None] * c1).transpose(-1, -2) @ c2
    U, D, Vt = torch.linalg.svd(Sigma)
    det = torch.linalg.det(U) * torch.linalg.det(Vt)
    S = torch.ones(D.shape[:-1] + (3,), dtype=x1.dtype, device=x1.device)
    S[..., 2] = torch.where(det < 0, -1.0, 1.0)
    R = U @ (S[..., :, None] * Vt)
    var2 = (wn[..., :, None] * c2 * c2).sum(dim=(-2, -1))
    s = (D * S).sum(dim=-1) / torch.clamp_min(var2, _EPS)
    t = mu1 - s[..., None] * _mv(R, mu2)
    return Sim3(s=s, R=R, t=t)


class Sim3RansacResult(NamedTuple):
    g: Sim3
    inliers: torch.Tensor    # [N] bool
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool


def ransac_sim3(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor, u: torch.Tensor,
                tol: float = 0.05, min_inliers: int = 6) -> Sim3RansacResult:
    """RANSAC Sim(3) from matched 3D points, matched rows compacted to the
    front: one Horn solve per 3-point set drawn from the uniforms ``u
    [iterations, 3]`` (``sample_distinct``), inliers within the metric gate
    ``tol``, the winner (the first of the most inliers) refit on its
    inliers, the refit kept when it holds as many."""
    n_valid = valid.sum(dtype=torch.int32)
    idx = sample_distinct(u, n_valid, 3).long()             # [S, 3]
    g = solve_sim3_horn(x1[idx], x2[idx])                  # batched [S]
    err = torch.linalg.vector_norm(sim3_apply(g, x2) - x1[None], dim=-1)   # [S, N]
    inl = (err < tol) & valid[None, :]
    scores = inl.sum(dim=-1, dtype=torch.int32)
    b = torch.argmax(scores).reshape(1)    # the first maximum, as jnp.argmax
    inl_b = inl.index_select(0, b)[0]
    g_fit = solve_sim3_horn(x1, x2, inl_b.to(x1.dtype))
    inl_fit = (torch.linalg.vector_norm(sim3_apply(g_fit, x2) - x1, dim=-1) < tol) & valid
    better = inl_fit.sum(dtype=torch.int32) >= scores.index_select(0, b)[0]
    g_best = Sim3(s=torch.where(better, g_fit.s, g.s.index_select(0, b)[0]),
                  R=torch.where(better, g_fit.R, g.R.index_select(0, b)[0]),
                  t=torch.where(better, g_fit.t, g.t.index_select(0, b)[0]))
    inliers = torch.where(better, inl_fit, inl_b)
    n = inliers.sum(dtype=torch.int32)
    return Sim3RansacResult(g=g_best, inliers=inliers, n_inliers=n, ok=n >= min_inliers)


def optimize_sim3(g0: Sim3, x1: torch.Tensor, x2: torch.Tensor, uv1: torch.Tensor,
                  uv2: torch.Tensor, K: torch.Tensor, valid: torch.Tensor,
                  iterations: int = 10, fix_scale: bool = False) -> Tuple[Sim3, torch.Tensor]:
    """Robust LM over Sim(3) on ``|uv1 - proj(g(x2))|^2 + |uv2 -
    proj(g^-1(x1))|^2``, Huber-weighted, left increments, every one of the
    ``iterations`` steps taken (a rejected step keeps the estimate). ->
    (g, inliers): both directions' chi2 within ``HUBER_CHI2``, as g2o's
    OptimizeSim3 erases a pair when either edge exceeds it."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    eye = torch.eye(3, dtype=x1.dtype, device=x1.device)

    def proj_jac(pc):
        x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
        zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        uv = torch.stack([fx * x * zi + cx, fy * y * zi + cy], dim=-1)
        zero = torch.zeros_like(x)
        Jp = torch.stack([torch.stack([fx * zi, zero, -fx * x * zi * zi], dim=-1),
                          torch.stack([zero, fy * zi, -fy * y * zi * zi], dim=-1)], dim=-2)
        return uv, Jp

    wv = valid.to(x1.dtype)

    def residuals(g):
        # forward: x2 through g into image 1; d p1 / d xi = [I, -hat(p1), p1]
        p1 = sim3_apply(g, x2)
        uvh1, Jp1 = proj_jac(p1)
        Jpc1 = torch.cat([eye.expand(p1.shape[:-1] + (3, 3)), -hat(p1), p1[..., :, None]],
                         dim=-1)
        # inverse: x1 through g^-1 into image 2, M = (1/s) R^T:
        # d p2 / d rho = -M, d p2 / d phi = M hat(x1), d p2 / d sigma = -M x1
        gi = sim3_inverse(g)
        p2 = sim3_apply(gi, x1)
        uvh2, Jp2 = proj_jac(p2)
        M = gi.s * gi.R
        Jpc2 = torch.cat([(-M).expand(p2.shape[:-1] + (3, 3)), M @ hat(x1),
                          -(x1 @ M.T)[..., :, None]], dim=-1)
        return uvh1 - uv1, Jp1 @ Jpc1, uvh2 - uv2, Jp2 @ Jpc2

    def chi2_dir(g):
        r1, _, r2, _ = residuals(g)
        return (r1 * r1).sum(-1) * wv, (r2 * r2).sum(-1) * wv

    def cost_of(g):
        c1, c2 = chi2_dir(g)
        c = c1 + c2
        return torch.where(c <= HUBER_CHI2, c,
                           2.0 * torch.sqrt(HUBER_CHI2 * c) - HUBER_CHI2).sum()

    def irls(c):
        return torch.where(c <= HUBER_CHI2, 1.0,
                           torch.sqrt(HUBER_CHI2 / torch.clamp_min(c, _EPS))) * wv

    g = g0
    lam = torch.tensor(1e-3, dtype=x1.dtype, device=x1.device)
    cost = cost_of(g)
    for _ in range(iterations):
        r1, J1, r2, J2 = residuals(g)
        w1 = irls((r1 * r1).sum(-1) * wv)
        w2 = irls((r2 * r2).sum(-1) * wv)
        H = (torch.einsum("nri,n,nrj->ij", J1, w1, J1)
             + torch.einsum("nri,n,nrj->ij", J2, w2, J2))
        b = torch.einsum("nri,n,nr->i", J1, w1, r1) + torch.einsum("nri,n,nr->i", J2, w2, r2)
        if fix_scale:
            H = H.clone()
            H[6, :] = 0.0
            H[:, 6] = 0.0
            H[6, 6] = 1.0
            b = torch.cat([b[:6], torch.zeros_like(b[6:])])
        Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-9 * torch.eye(7, dtype=H.dtype,
                                                                        device=H.device)
        xi = -torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
        g_new = sim3_compose(sim3_exp(xi), g)
        new_cost = cost_of(g_new)
        good = new_cost < cost
        g = Sim3(s=torch.where(good, g_new.s, g.s), R=torch.where(good, g_new.R, g.R),
                 t=torch.where(good, g_new.t, g.t))
        cost = torch.where(good, new_cost, cost)
        lam = torch.where(good, lam * 0.5, lam * 4.0)
    c1, c2 = chi2_dir(g)
    return g, (c1 <= HUBER_CHI2) & (c2 <= HUBER_CHI2) & valid
