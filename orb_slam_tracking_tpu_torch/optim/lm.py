"""Levenberg-Marquardt pieces (counterpart of ``optim/lm.py``): the Huber
IRLS weight, Nielsen's damping schedule and the damped 6x6 solve."""

from __future__ import annotations

import torch

__all__ = ["huber_weight", "nielsen_update", "solve_damped"]


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


def solve_damped(H: torch.Tensor, b: torch.Tensor,
                 lam: torch.Tensor) -> torch.Tensor:
    """Solve (H + lam * diag(H)) dx = b by pivoted LU.

    ``solve_ex`` skips the error check, so no host sync happens here; a
    singular system yields non-finite dx, which the caller's cost test
    rejects."""
    Hd = H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
    return torch.linalg.solve_ex(Hd, b[..., None])[0][..., 0]
