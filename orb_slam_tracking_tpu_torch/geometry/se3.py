"""SE(3) / SO(3) exponential maps (counterpart of ``geometry/se3.py``).

Poses are ``(R [..., 3, 3], t [..., 3])`` and tangent vectors
``[..., 6] = (omega, v)``, rotation first as in g2o. Everything is f32.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["hat", "so3_exp", "left_jacobian", "se3_exp"]

_EPS = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of ``omega [..., 3]`` -> ``[..., 3, 3]``."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zero = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([zero, -wz, wy], dim=-1),
        torch.stack([wz, zero, -wx], dim=-1),
        torch.stack([-wy, wx, zero], dim=-1),
    ], dim=-2)


def _sinc_terms(theta2: torch.Tensor):
    """Taylor-guarded (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3)."""
    theta = torch.sqrt(theta2 + _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / (theta2 + _EPS))
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta + _EPS))
    return a, b, c


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ``omega [..., 3]`` -> rotation ``[..., 3, 3]``."""
    a, b, _ = _sinc_terms((omega * omega).sum(dim=-1))
    K = hat(omega)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian V such that the se3_exp translation is V @ v."""
    _, b, c = _sinc_terms((omega * omega).sum(dim=-1))
    K = hat(omega)
    return _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent ``[..., 6] (omega, v)`` -> ``(R [..., 3, 3], t [..., 3])``."""
    omega, v = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (left_jacobian(omega) @ v[..., None])[..., 0]
    return R, t
