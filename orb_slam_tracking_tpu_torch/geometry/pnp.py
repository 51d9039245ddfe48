"""Batched RANSAC PnP: a camera pose from 2D-3D correspondences
(counterpart of ``geometry/pnp.py``, relocalization's back end).

Every hypothesis solves at once: a 6-point DLT for the 3x4 projection
matrix through the least eigenvector of AᵀA, the pose taken from it by
orthonormalising the rotation block with an SVD, every hypothesis scored
against every match, then the top 32 consensus sets refit by weighted DLT
under a tightening tolerance (LO-RANSAC). The minimal sets' uniforms come
in as an argument, as for ``sample_distinct``: the JAX package draws them
with ``jax.random.uniform(key, (iterations, 6))``.

``torch.linalg.eigh`` and ``svd`` check their convergence on the host, so
a call syncs; the best hypothesis is taken with ``index_select``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .sampling import sample_distinct

__all__ = ["PnPResult", "ransac_pnp"]


class PnPResult(NamedTuple):
    R: torch.Tensor          # [3, 3] world-to-camera
    t: torch.Tensor          # [3]
    inliers: torch.Tensor    # [M] bool
    n_inliers: torch.Tensor  # [] int32
    ok: torch.Tensor         # [] bool (the best hypothesis has >= 6 inliers)


def _solve_pnp_dlt(X, x, w=None):
    """Batched DLT for P [.., 3, 4] from [.., N >= 6, 3] world points and
    [.., N, 2] normalised image coordinates; optional row weights [.., N]."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)      # [.., N, 4]
    zeros = torch.zeros_like(Xh)
    u, v = x[..., 0:1], x[..., 1:2]
    r1 = torch.cat([Xh, zeros, -u * Xh], dim=-1)                 # [.., N, 12]
    r2 = torch.cat([zeros, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                              # [.., 2N, 12]
    if w is not None:
        A = A * torch.cat([w, w], dim=-1)[..., None]
    p = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :, 0]
    return p.reshape(p.shape[:-1] + (3, 4))


def _pose_from_P(P):
    """(R, t) from P ~ s [R | t] of either sign: flip so the rotation block
    has a positive determinant, take the closest rotation and the
    translation at the block's mean singular value."""
    M = P[..., :3]
    sgn = torch.where(torch.linalg.det(M) < 0, -1.0, 1.0)
    M = M * sgn[..., None, None]
    U, S, Vt = torch.linalg.svd(M)
    R = U @ Vt
    scale = S.mean(dim=-1)
    t = sgn[..., None] * P[..., 3] / torch.where(scale < 1e-12, 1e-12, scale)[..., None]
    return R, t


def ransac_pnp(pts: torch.Tensor, uv: torch.Tensor, valid: torch.Tensor,
               K: torch.Tensor, u: torch.Tensor, chi2_th: float = 5.991) -> PnPResult:
    """RANSAC pose from [M, 3] world points and [M, 2] pixel observations,
    the valid rows compacted to the front. ``u`` [iterations, 6] uniforms
    in [0, 1) pick the minimal sets."""
    n_valid = valid.sum(dtype=torch.int32)
    x = torch.stack([(uv[:, 0] - K[0, 2]) / K[0, 0], (uv[:, 1] - K[1, 2]) / K[1, 1]], dim=-1)
    idx = sample_distinct(u, n_valid, 6).long()
    R, t = _pose_from_P(_solve_pnp_dlt(pts[idx], x[idx]))       # [S, 3, 3], [S, 3]
    f2 = K[0, 0] * K[1, 1]

    def classify(Rh, th, tol_chi2):
        pc = torch.einsum("...ij,mj->...mi", Rh, pts) + th[..., None, :]
        z = pc[..., 2]
        zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
        err = ((pc[..., :2] * zi[..., None] - x) ** 2).sum(dim=-1)
        return (err * f2 < tol_chi2) & (z > 0) & valid

    # score with a wide tolerance, then refit the top-k consensus sets by
    # weighted DLT under a tightening schedule that stops at a moderate
    # tolerance (the caller's geometric LM does the final tightening)
    wide = 40.0 ** 2
    topk = 32
    inl_wide = classify(R, t, wide)                             # [S, M]
    scores = inl_wide.sum(dim=-1, dtype=torch.int32)
    top = torch.sort(scores, descending=True, stable=True).indices[:topk]  # lax.top_k's order
    w = inl_wide[top].to(torch.float32)
    pts_b = pts.expand((top.shape[0],) + pts.shape)
    x_b = x.expand((top.shape[0],) + x.shape)
    for tol in (wide / 4.0, chi2_th * 16.0, chi2_th * 4.0):
        Rb, tb = _pose_from_P(_solve_pnp_dlt(pts_b, x_b, w))
        inl = classify(Rb, tb, tol)
        w = inl.to(torch.float32)
    n_per = inl.sum(dim=-1, dtype=torch.int32)
    b = torch.argmax(n_per).reshape(1)   # the first maximum, as jnp.argmax
    n_best = n_per.index_select(0, b)[0]
    return PnPResult(R=Rb.index_select(0, b)[0], t=tb.index_select(0, b)[0],
                     inliers=inl.index_select(0, b)[0], n_inliers=n_best, ok=n_best >= 6)
