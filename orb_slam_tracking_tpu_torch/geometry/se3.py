"""SE(3) / SO(3) exponential maps (counterpart of ``geometry/se3.py``).

Poses are ``(R [..., 3, 3], t [..., 3])`` and tangent vectors
``[..., 6] = (omega, v)``, rotation first as in g2o. Everything is f32.

``so3_log`` goes through the quaternion (Shepperd's extraction, every
candidate computed and the largest pivot selected), as the JAX package's
does; its small-angle branches are double ``where``s, so forward-mode
derivatives (``torch.func.jacfwd``) stay finite at the identity.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["hat", "so3_exp", "so3_log", "left_jacobian", "se3_exp",
           "rotation_to_quaternion", "quaternion_to_axis_angle"]

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


def rotation_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> unit quaternion ``[..., 4]`` (w, x, y, z),
    w >= 0: the four pivot candidates, the largest pivot taken (the first
    on ties, as ``jnp.argmax``)."""
    R00, R11, R22 = R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]
    pivots = torch.stack([1.0 + R00 + R11 + R22, 1.0 + R00 - R11 - R22,
                          1.0 - R00 + R11 - R22, 1.0 - R00 - R11 + R22], dim=-1)
    s = torch.sqrt(torch.clamp_min(pivots, _EPS))                  # [..., 4]
    inv = 0.5 / s
    d21, d02, d10 = R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0], R[..., 1, 0] - R[..., 0, 1]
    s01, s02, s12 = R[..., 0, 1] + R[..., 1, 0], R[..., 0, 2] + R[..., 2, 0], R[..., 1, 2] + R[..., 2, 1]
    iw, ix, iy, iz = inv.unbind(-1)
    cands = torch.stack([
        torch.stack([0.5 * s[..., 0], d21 * iw, d02 * iw, d10 * iw], dim=-1),
        torch.stack([d21 * ix, 0.5 * s[..., 1], s01 * ix, s02 * ix], dim=-1),
        torch.stack([d02 * iy, s01 * iy, 0.5 * s[..., 2], s12 * iy], dim=-1),
        torch.stack([d10 * iz, s02 * iz, s12 * iz, 0.5 * s[..., 3]], dim=-1),
    ], dim=-2)                                                     # [..., 4 cand, 4]
    best = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, best[..., None, None].expand(best.shape + (1, 4)))[..., 0, :]
    q = q / (torch.linalg.vector_norm(q, dim=-1, keepdim=True) + _EPS)
    return torch.where(q[..., :1] < 0, -q, q)


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> axis-angle ``[..., 3]``. The norm of
    the vector part is guarded twice (``where`` before the square root), so
    its derivative is finite at the identity; the small branch's scale is
    the Taylor limit 2 + x^2 / 3 of 2 asin(x) / x."""
    qw = q[..., 0].abs()
    qv = torch.where(q[..., :1] < 0, -q[..., 1:], q[..., 1:])
    sq = (qv * qv).sum(dim=-1)
    small = sq < 1e-12
    sin_half = torch.sqrt(torch.where(small, 1.0, sq))
    theta = 2.0 * torch.atan2(sin_half, qw)
    scale = torch.where(small, 2.0 + sq / 3.0, theta / (sin_half + _EPS))
    return scale[..., None] * qv


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation ``[..., 3, 3]`` -> axis-angle ``[..., 3]``, through the
    quaternion (well conditioned in f32 up to theta = pi)."""
    return quaternion_to_axis_angle(rotation_to_quaternion(R))
