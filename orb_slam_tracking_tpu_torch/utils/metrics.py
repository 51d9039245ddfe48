"""Trajectory evaluation: ATE after a Sim(3) (or SE(3)) Umeyama alignment
(counterpart of ``utils/metrics.py``; numpy only), and the relative pose
error.

Monocular trajectories are defined up to scale, so the absolute
trajectory error is taken after a similarity alignment, the TUM
benchmark's method.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["umeyama_alignment", "ate_rmse", "rpe_stats"]


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


def rpe_stats(est_Rt, gt_Rt, delta: int = 1, scale: float = 1.0) -> Tuple[float, float]:
    """Relative pose error over frame gaps of ``delta`` (the TUM benchmark's
    drift metric, ``evaluate_rpe.py``): (RMS translational drift per step,
    RMS rotation angle of the residual in degrees).

    ``est_Rt``, ``gt_Rt``: equal-length lists of world-to-camera (R [3, 3],
    t [3]) at corresponding timestamps; ``scale`` (the Umeyama scale of the
    ATE alignment) rescales the estimated translations first."""
    terrs = []
    rerrs = []
    for i in range(len(est_Rt) - delta):
        R1e, t1e = est_Rt[i]
        R2e, t2e = est_Rt[i + delta]
        R1g, t1g = gt_Rt[i]
        R2g, t2g = gt_Rt[i + delta]
        # camera-to-camera relative motion, cam_i -> cam_{i+delta}
        Re = R2e @ R1e.T
        te = scale * (t2e - Re @ t1e)
        Rg = R2g @ R1g.T
        tg = t2g - Rg @ t1g
        Rres = Re.T @ Rg
        terrs.append(np.sum((te - tg) ** 2))
        ang = np.degrees(np.arccos(np.clip((np.trace(Rres) - 1.0) / 2.0, -1.0, 1.0)))
        rerrs.append(ang ** 2)
    if not terrs:
        return 0.0, 0.0
    return float(np.sqrt(np.mean(terrs))), float(np.sqrt(np.mean(rerrs)))
