"""Batched fundamental-matrix estimation and essential decomposition
(counterpart of ``geometry/fundamental.py``): the normalised 8-point
algorithm through the least eigenvector of AᵀA, rank 2 enforced with a
batched 3x3 SVD, and ``cv::decomposeEssentialMat``'s four candidates."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .homography import normalize_points

__all__ = ["solve_f_8point", "decompose_essential"]

_EPS = 1e-12


def solve_f_8point(x1: torch.Tensor, x2: torch.Tensor,
                   w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Batched F21 (x2ᵀ F x1 = 0) from ``x1, x2 [..., N, 2]``, N >= 8;
    weights ``w [..., N]`` zero out rows. [..., 3, 3] of rank 2, up to
    scale and sign."""
    x1n, T1 = normalize_points(x1, w)
    x2n, T2 = normalize_points(x2, w)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    A = torch.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v,
                     torch.ones_like(u)], dim=-1)  # [..., N, 9]
    if w is not None:
        A = A * w[..., None]
    f = torch.linalg.eigh(A.transpose(-1, -2) @ A).eigenvectors[..., :, 0]
    Fn = f.reshape(f.shape[:-1] + (3, 3))
    U, S, Vt = torch.linalg.svd(Fn)
    S2 = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    Fn = U @ (S2[..., :, None] * Vt)
    return (T2.transpose(-1, -2) @ Fn) @ T1


def decompose_essential(F: torch.Tensor, K: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """E = Kᵀ F K -> (R [4, 3, 3], t [4, 3] unit norm): {R1, R2} x {t, -t}
    with det(R) = +1."""
    E = (K.T @ F) @ K
    U, _, Vt = torch.linalg.svd(E)
    U = torch.where(torch.linalg.det(U) < 0, -U, U)
    Vt = torch.where(torch.linalg.det(Vt) < 0, -Vt, Vt)
    # U @ W and U @ Wᵀ for W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], as
    # signed column swaps (the same values, and no host-to-device copy)
    UW = torch.stack([U[:, 1], -U[:, 0], U[:, 2]], dim=1)
    UWt = torch.stack([-U[:, 1], U[:, 0], U[:, 2]], dim=1)
    R1 = UW @ Vt
    R2 = UWt @ Vt
    t = U[:, 2]
    t = t / (torch.linalg.vector_norm(t) + _EPS)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])
