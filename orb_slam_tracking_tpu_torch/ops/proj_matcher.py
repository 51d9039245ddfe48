"""Projection-guided map-point -> keypoint matching (counterpart of
``ops/proj_matcher.py``, ORB-SLAM's ``SearchByProjection``).

Map points are projected with the predicted pose; each visible point takes
the keypoint of least Hamming distance inside its radius window (scaled by
octave), under ``th_high``, with mutual resolution: one map point per
keypoint, the closest winning and the lower point index breaking ties.
Per-point viewing statistics (normal, dmin, dmax) drive the
``Frame::isInFrustum`` gates; ``dmax == 0`` disables them for that point.
The per-point least distance inside the window comes from the
``hamming_gated_min`` kernel wrapper, which never forms the [P, N]
distance matrix. A leading [B] on the map, the pose and the keypoints
(``K`` shared) matches B sequences with one kernel launch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..config import MatcherConfig
from .hamming import hamming_gated_min

__all__ = ["ProjMatchResult", "search_by_projection"]

_SENTINEL = torch.iinfo(torch.int32).max
_INT_MIN = torch.iinfo(torch.int32).min


@functools.lru_cache(maxsize=8)
def _log_f32(x: float) -> float:
    """``log(x)`` as the JAX package takes it, ``jnp.log`` of the f32 ``x``.
    PredictScale's ``ceil(log(dmax / dist) / log(s))`` sits on an integer
    whenever the camera is where the point's statistics were taken (the
    ratio is then a power of s), so one rounding there moves the predicted
    octave, its window and its octave gate by a level: the float64 log of
    s, 5e-8 below the f32 one, did (``tests/test_torch_device_recovery.py``)."""
    return float(np.log(np.float32(x)))


class ProjMatchResult(NamedTuple):
    kp_for_point: torch.Tensor  # [(B,) P] int32 keypoint index or -1
    point_for_kp: torch.Tensor  # [(B,) N] int32 map-point index or -1
    uv_proj: torch.Tensor       # [(B,) P, 2] projected pixel of each map point
    n_matches: torch.Tensor     # [(B,)] int32
    n_visible: torch.Tensor     # [(B,)] int32
    visible: torch.Tensor       # [(B,) P] bool frustum visibility


def search_by_projection(
    map_pts: torch.Tensor, map_desc: torch.Tensor, map_valid: torch.Tensor,
    R: torch.Tensor, t: torch.Tensor, K: torch.Tensor,
    kp_desc: torch.Tensor, kp_xy: torch.Tensor, kp_valid: torch.Tensor,
    radius: float, cfg: MatcherConfig, width: int, height: int,
    kp_octave: torch.Tensor, scale_factor: float,
    pt_normal: torch.Tensor, pt_dmin: torch.Tensor, pt_dmax: torch.Tensor,
    n_levels: int,
) -> ProjMatchResult:
    """Match map points [(B,) P] to keypoints [(B,) N] around their
    projections under (R, t) [(B,) 3, 3], [(B,) 3]; ``kp_xy`` are
    undistorted keypoint pixels."""
    P = map_pts.shape[-2]
    N = kp_desc.shape[-2]
    lead = map_pts.shape[:-2]
    pc = map_pts @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zi = 1.0 / torch.where(z.abs() < 1e-9, 1e-9, z)
    u = K[0, 0] * pc[..., 0] * zi + K[0, 2]
    v = K[1, 1] * pc[..., 1] * zi + K[1, 2]
    uv = torch.stack([u, v], dim=-1)
    visible = map_valid & (z > 0.1) & (u >= 0) & (u < width) & (v >= 0) & (v < height)

    # isInFrustum gates: camera centre, viewing ray, scale envelope
    C = -(R.T @ t) if R.dim() == 2 else -(R.transpose(-1, -2) @ t[..., None])[..., 0]
    view = map_pts - C[..., None, :]
    dist = torch.linalg.vector_norm(view, dim=-1)
    has = pt_dmax > 0
    dist_ok = (dist >= 0.8 * pt_dmin) & (dist <= 1.2 * pt_dmax)
    angle_ok = (view * pt_normal).sum(dim=-1) / dist.clamp_min(1e-9) > 0.5
    visible = visible & (~has | (dist_ok & angle_ok))
    # predicted octave at this distance (MapPoint::PredictScale)
    ratio = pt_dmax.clamp_min(1e-9) / dist.clamp_min(1e-9)
    pred = torch.ceil(torch.log(ratio.clamp_min(1e-9)) / _log_f32(scale_factor))
    pred = pred.to(torch.int32).clamp(0, n_levels - 1)
    r_pt = torch.where(has, radius * scale_factor ** pred.to(torch.float32), 0.0)
    r_kp = radius * scale_factor ** kp_octave.to(torch.float32)  # [N]
    # octave gate: points with statistics take [pred - 1, pred + 1], others all
    oct_lo = torch.where(has, pred - 1, _INT_MIN)
    oct_hi = torch.where(has, pred + 1, _SENTINEL)
    best, best_j, _ = hamming_gated_min(
        map_desc, kp_desc, uv, r_pt, has, oct_lo, oct_hi, visible,
        kp_xy, r_kp, kp_octave.to(torch.int32), kp_valid)
    accept = (best <= cfg.th_high) & visible

    rows = torch.arange(P, dtype=torch.int32, device=map_pts.device)
    key = torch.where(accept, best * P + rows, _SENTINEL)
    min_key = torch.full(lead + (N,), _SENTINEL, dtype=torch.int32,
                         device=map_pts.device)
    j = best_j.to(torch.int64)
    min_key.scatter_reduce_(-1, j, key, "amin")
    keep = accept & (key == min_key.gather(-1, j))

    kp_for_point = torch.where(keep, best_j, -1)
    # keypoint -> point: rows not kept write to a spare slot N, dropped
    point_for_kp = torch.full(lead + (N + 1,), -1, dtype=torch.int32,
                              device=map_pts.device)
    point_for_kp.scatter_(-1, torch.where(keep, j, N), rows.expand(j.shape))
    return ProjMatchResult(
        kp_for_point=kp_for_point,
        point_for_kp=point_for_kp[..., :N],
        uv_proj=uv,
        n_matches=keep.sum(dim=-1, dtype=torch.int32),
        n_visible=visible.sum(dim=-1, dtype=torch.int32),
        visible=visible,
    )
