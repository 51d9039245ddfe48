"""Batched homography estimation and decomposition (counterpart of
``geometry/homography.py``).

A normalised 8-point DLT solved through the eigenvector of the least
eigenvalue of AᵀA, hypotheses stacked on a leading axis, and the Faugeras
& Lustman 8-solution decomposition (ORB-SLAM's ``ReconstructH``). The
SVD's column signs are arbitrary, so the 8 candidates may come in another
order than the JAX package's; the set is the same.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["normalize_points", "solve_h_dlt", "decompose_homography"]

_EPS = 1e-12


def normalize_points(x: torch.Tensor, w: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Similarity-normalise point sets ``x [..., N, 2]`` (mean-absolute-
    deviation scaling, ORB-SLAM's ``Normalize``) -> (xn [..., N, 2],
    T [..., 3, 3]) with xn = T x. Weights ``w [..., N]`` restrict the
    statistics to a subset (inlier refits)."""
    if w is None:
        mean = x.mean(dim=-2, keepdim=True)
        d = x - mean
        dev = d.abs().mean(dim=-2, keepdim=True) + _EPS
    else:
        wk = w[..., None]
        tot = wk.sum(dim=-2, keepdim=True).clamp_min(_EPS)
        mean = (x * wk).sum(dim=-2, keepdim=True) / tot
        d = x - mean
        dev = (d.abs() * wk).sum(dim=-2, keepdim=True) / tot + _EPS
    s = 1.0 / dev
    xn = d * s
    sx, sy = s[..., 0, 0], s[..., 0, 1]
    mx, my = mean[..., 0, 0], mean[..., 0, 1]
    zero = torch.zeros_like(sx)
    one = torch.ones_like(sx)
    T = torch.stack([
        torch.stack([sx, zero, -mx * sx], dim=-1),
        torch.stack([zero, sy, -my * sy], dim=-1),
        torch.stack([zero, zero, one], dim=-1),
    ], dim=-2)
    return xn, T


def solve_h_dlt(x1: torch.Tensor, x2: torch.Tensor,
                w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched H21 (view-1 points to view-2) from ``x1, x2 [..., N, 2]``,
    N >= 4; weights ``w [..., N]`` zero out rows. [..., 3, 3], up to scale
    and sign."""
    x1n, T1 = normalize_points(x1, w)
    x2n, T2 = normalize_points(x2, w)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    zero = torch.zeros_like(u)
    one = torch.ones_like(u)
    r1 = torch.stack([zero, zero, zero, -u, -v, -one, vp * u, vp * v, vp], dim=-1)
    r2 = torch.stack([u, v, one, zero, zero, zero, -up * u, -up * v, -up], dim=-1)
    A = torch.cat([r1, r2], dim=-2)  # [..., 2N, 9]
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    h = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :, 0]
    Hn = h.reshape(h.shape[:-1] + (3, 3))
    T2inv = torch.linalg.inv_ex(T2).inverse
    return (T2inv @ Hn) @ T1


def decompose_homography(H: torch.Tensor, K: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Faugeras 8-solution decomposition of a pixel homography H [3, 3]
    with intrinsics K -> (R [8, 3, 3], t [8, 3] unit norm, valid [8]).
    Coinciding singular values (pure rotation) flag all invalid."""
    Kinv = torch.linalg.inv_ex(K).inverse
    A = (Kinv @ H) @ K
    U, S, Vt = torch.linalg.svd(A)
    d1, d2, d3 = S[0], S[1], S[2]
    s = torch.linalg.det(U) * torch.linalg.det(Vt)

    denom = (d1 * d1 - d3 * d3).clamp_min(_EPS)
    x1 = torch.sqrt((d1 * d1 - d2 * d2).clamp_min(0.0) / denom)
    x3 = torch.sqrt((d2 * d2 - d3 * d3).clamp_min(0.0) / denom)
    # e1 = [1, 1, -1, -1], e3 = [1, -1, 1, -1], made on the device
    i4 = torch.arange(4, device=H.device)
    e1 = 1.0 - 2.0 * (i4 >= 2).to(H.dtype)
    e3 = 1.0 - 2.0 * (i4 % 2).to(H.dtype)
    d2s = d2.clamp_min(_EPS)
    zero = torch.zeros_like(e1)
    one = torch.ones_like(e1)

    def build(case_pos: bool):
        if case_pos:
            st = e1 * e3 * ((d1 - d3) * x1 * x3 / d2s)
            ct = ((d1 * x3 * x3 + d3 * x1 * x1) / d2s).expand(4)
            Rp = torch.stack([
                torch.stack([ct, zero, -st], dim=-1),
                torch.stack([zero, one, zero], dim=-1),
                torch.stack([st, zero, ct], dim=-1),
            ], dim=-2)
            tp = (d1 - d3) * torch.stack([e1 * x1, zero, -e3 * x3], dim=-1)
        else:
            sp = e1 * e3 * ((d1 + d3) * x1 * x3 / d2s)
            cp = ((d3 * x1 * x1 - d1 * x3 * x3) / d2s).expand(4)
            Rp = torch.stack([
                torch.stack([cp, zero, sp], dim=-1),
                torch.stack([zero, -one, zero], dim=-1),
                torch.stack([sp, zero, -cp], dim=-1),
            ], dim=-2)
            tp = (d1 + d3) * torch.stack([e1 * x1, zero, e3 * x3], dim=-1)
        R = s * ((U[None] @ Rp) @ Vt[None])
        t = tp @ U.T
        t = t / (torch.linalg.vector_norm(t, dim=-1, keepdim=True) + _EPS)
        return R, t

    Rpos, tpos = build(True)
    Rneg, tneg = build(False)
    ok = (d1 / d2s > 1.0001) | (d2 / d3.clamp_min(_EPS) > 1.0001)
    return (torch.cat([Rpos, Rneg]), torch.cat([tpos, tneg]), ok.expand(8))
