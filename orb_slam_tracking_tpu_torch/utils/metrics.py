"""Trajectory evaluation: ATE after a Sim(3) (or SE(3)) Umeyama alignment
(counterpart of ``utils/metrics.py``; numpy only).

Monocular trajectories are defined up to scale, so the absolute
trajectory error is taken after a similarity alignment, the TUM
benchmark's method.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["umeyama_alignment", "ate_rmse"]


def umeyama_alignment(src: np.ndarray, dst: np.ndarray, with_scale: bool = True
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
    """Least-squares similarity transform aligning src -> dst.

    src, dst: [N, 3]. Returns (R, t, s) with dst ~ s * R @ src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs ** 2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / max(var_s, 1e-12))
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return R, t, s


def ate_rmse(est_centres: np.ndarray, gt_centres: np.ndarray,
             with_scale: bool = True) -> float:
    """RMSE of aligned camera-centre positions (same length, corresponding
    timestamps)."""
    R, t, s = umeyama_alignment(est_centres, gt_centres, with_scale)
    aligned = (s * (R @ est_centres.T)).T + t
    return float(np.sqrt(np.mean(np.sum((aligned - gt_centres) ** 2, axis=-1))))
