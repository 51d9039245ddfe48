"""Batched DLT triangulation (counterpart of ``geometry/triangulate.py``,
``cv::triangulatePoints``): the 4x4 DLT system of every (pose, point) pair
solved at once through the eigenvector of the least eigenvalue of AᵀA.
The eigenvector's sign is arbitrary; the dehomogenised point is not."""

from __future__ import annotations

import torch

__all__ = ["triangulate_dlt"]


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """P1, P2 [..., 3, 4] projection matrices; x1, x2 [..., N, 2] pixels ->
    [..., N, 3] points."""
    r0 = x1[..., :, 0:1] * P1[..., None, 2, :] - P1[..., None, 0, :]
    r1 = x1[..., :, 1:2] * P1[..., None, 2, :] - P1[..., None, 1, :]
    r2 = x2[..., :, 0:1] * P2[..., None, 2, :] - P2[..., None, 0, :]
    r3 = x2[..., :, 1:2] * P2[..., None, 2, :] - P2[..., None, 1, :]
    A = torch.stack([r0, r1, r2, r3], dim=-2)  # [..., N, 4, 4]
    AtA = A.transpose(-1, -2) @ A
    X = torch.linalg.eigh(AtA).eigenvectors[..., :, 0]  # ascending eigenvalues
    w = X[..., 3:4]
    w = torch.where(w.abs() < 1e-12, torch.sign(w) * 1e-12 + (w == 0) * 1e-12, w)
    return X[..., :3] / w
