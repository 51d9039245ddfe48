"""Levenberg-Marquardt pieces (counterpart of ``optim/lm.py``): the Huber
IRLS weight, Nielsen's damping schedule, the damped 6x6 solve (pivoted LU,
or for batched systems the closed-form block-Schur ``solve_spd6``) and the
closed-form 3x3 inverse of bundle adjustment's point blocks."""

from __future__ import annotations

import torch

__all__ = ["huber_weight", "inv3x3", "nielsen_update", "solve_damped", "solve_spd6"]


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """w = 1 inside, delta/|e| outside (g2o ``RobustKernelHuber``)."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / chi2.clamp_min(1e-20)))


def nielsen_update(lam: torch.Tensor, nu: torch.Tensor, rho: torch.Tensor):
    """g2o's schedule: on success scale lambda by max(1/3, 1-(2 rho-1)^3) and
    reset nu; on failure multiply lambda by nu and double nu."""
    good = rho > 0
    factor = torch.clamp_min(1.0 - (2.0 * rho - 1.0) ** 3, 1.0 / 3.0)
    lam_new = torch.where(good, lam * factor, lam * nu)
    nu_new = torch.where(good, torch.full_like(nu, 2.0), nu * 2.0)
    return lam_new, nu_new


def solve_spd6(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve symmetric positive-definite 6x6 systems ``M [..., 6, 6] x =
    b [..., 6]`` in closed form, by 3x3 block Schur elimination with
    adjugate inverses: ``S = D - B^T A^-1 B``. Valid for the damped normal
    equations (SPD by construction, the damping floor keeping A and S away
    from singularity); branch-free, so a batch of systems is a handful of
    elementwise passes where LU would loop its pivots per system."""
    A = M[..., :3, :3]
    Bm = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    b1 = b[..., :3]
    b2 = b[..., 3:]
    Ainv = inv3x3(A)
    AinvB = Ainv @ Bm
    S = D - Bm.transpose(-1, -2) @ AinvB
    Sinv = inv3x3(S)
    Ainv_b1 = torch.einsum("...ij,...j->...i", Ainv, b1)
    rhs2 = b2 - torch.einsum("...ji,...j->...i", Bm, Ainv_b1)
    x2 = torch.einsum("...ij,...j->...i", Sinv, rhs2)
    x1 = Ainv_b1 - torch.einsum("...ij,...j->...i", AinvB, x2)
    return torch.cat([x1, x2], dim=-1)


def solve_damped(H: torch.Tensor, b: torch.Tensor, lam: torch.Tensor,
                 batched: bool = False) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dx = b: with ``batched`` a [..., 6, 6] H by
    the closed form ``solve_spd6`` (the JAX package's switch, which its
    multi-sequence runners set), else by pivoted LU.

    ``solve_ex`` skips the error check, so no host sync happens here; a
    singular system yields non-finite dx, which the caller's cost test
    rejects."""
    Hd = H + lam[..., None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
    if batched and H.shape[-1] == 6:
        return solve_spd6(Hd, b)
    return torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]


def inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / determinant); a
    determinant below 1e-12 in magnitude is replaced by 1e-12."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    det = torch.where(det.abs() < 1e-12, 1e-12, det)
    adj = torch.stack([
        torch.stack([A, -(b * i - c * h), b * f - c * e], dim=-1),
        torch.stack([B, a * i - c * g, -(a * f - c * d)], dim=-1),
        torch.stack([C, -(a * h - b * g), a * e - b * d], dim=-1),
    ], dim=-2)
    return adj / det[..., None, None]
