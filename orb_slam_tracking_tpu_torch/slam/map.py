"""The fixed-capacity SLAM map (counterpart of ``slam/map.py``).

No pointer graphs: preallocated tensors with validity masks, every
capacity fixed by ``TrackerConfig`` and the keypoint capacity of the
extractor.

- map points: positions, descriptors (int32 words with the JAX package's
  uint32 bits), observation counts, the visible/found tallies of
  found-ratio culling, the keyframe-age stamp and the viewing statistics
  (mean viewing direction, scale-invariance distance envelope);
- keyframes: poses, frame ids and keypoint snapshots (undistorted pixels,
  descriptors, octaves, angles, validity, keypoint -> point association);
- a COO observation list (keyframe, point, keypoint, pixel, information,
  validity) that bundle adjustment reads.

Slots of all three are recycled: culling clears a validity bit, and
``free_slots`` finds the freed rows again, lowest first.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import TrackerConfig
from ..optim.segment import segment_sum, segments

__all__ = ["SlamMap", "empty_map", "free_slots", "update_normal_and_depth",
           "apply_ba_result", "OBS_PER_KF"]

# observation-list capacity per keyframe slot
OBS_PER_KF = 512


class SlamMap(NamedTuple):
    # map points
    pts: torch.Tensor          # [P, 3] float32 world positions
    desc: torch.Tensor         # [P, 8] int32 representative descriptor
    pt_valid: torch.Tensor     # [P] bool
    n_obs: torch.Tensor        # [P] int32 keyframe observations
    pt_birth_kf: torch.Tensor  # [P] int32 keyframe count at creation
    pt_visible: torch.Tensor   # [P] int32 frames where predicted visible
    pt_found: torch.Tensor     # [P] int32 frames where matched
    pt_normal: torch.Tensor    # [P, 3] float32 mean viewing direction
    pt_dmin: torch.Tensor      # [P] float32 (dmax == 0: no viewing info yet)
    pt_dmax: torch.Tensor      # [P] float32
    # keyframes
    kf_R: torch.Tensor         # [Kc, 3, 3] world-to-camera
    kf_t: torch.Tensor         # [Kc, 3]
    kf_valid: torch.Tensor     # [Kc] bool
    kf_frame_id: torch.Tensor  # [Kc] int32
    # per-keyframe keypoint snapshots
    kf_kp_xy: torch.Tensor     # [Kc, N, 2] float32 undistorted pixels
    kf_kp_desc: torch.Tensor   # [Kc, N, 8] int32
    kf_kp_octave: torch.Tensor  # [Kc, N] int32
    kf_kp_angle: torch.Tensor   # [Kc, N] float32 degrees
    kf_kp_valid: torch.Tensor   # [Kc, N] bool
    kf_kp_pt: torch.Tensor      # [Kc, N] int32 map-point slot or -1
    # observations (COO)
    obs_kf: torch.Tensor       # [O] int32 keyframe slot
    obs_pt: torch.Tensor       # [O] int32 map-point slot
    obs_kp: torch.Tensor       # [O] int32 keypoint index in the snapshot
    obs_uv: torch.Tensor       # [O, 2] float32 undistorted pixels
    obs_inv_sigma2: torch.Tensor  # [O] float32 information (per octave)
    obs_valid: torch.Tensor    # [O] bool

    @property
    def point_capacity(self) -> int:
        return self.pts.shape[0]

    @property
    def kf_capacity(self) -> int:
        return self.kf_R.shape[0]

    @property
    def kp_capacity(self) -> int:
        return self.kf_kp_xy.shape[1]

    def n_points(self) -> torch.Tensor:
        return self.pt_valid.sum(dtype=torch.int32)

    def n_keyframes(self) -> torch.Tensor:
        return self.kf_valid.sum(dtype=torch.int32)


def empty_map(cfg: TrackerConfig, kp_capacity: int = 2048,
              device: torch.device | str = "cpu") -> SlamMap:
    P, Kc, N = cfg.max_map_points, cfg.max_keyframes, kp_capacity
    O = Kc * OBS_PER_KF

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32 = torch.int32
    return SlamMap(
        pts=z(P, 3), desc=z(P, 8, dtype=i32), pt_valid=z(P, dtype=torch.bool),
        n_obs=z(P, dtype=i32), pt_birth_kf=z(P, dtype=i32),
        pt_visible=z(P, dtype=i32), pt_found=z(P, dtype=i32),
        pt_normal=z(P, 3), pt_dmin=z(P), pt_dmax=z(P),
        kf_R=torch.eye(3, device=device).repeat(Kc, 1, 1), kf_t=z(Kc, 3),
        kf_valid=z(Kc, dtype=torch.bool),
        kf_frame_id=torch.full((Kc,), -1, dtype=i32, device=device),
        kf_kp_xy=z(Kc, N, 2), kf_kp_desc=z(Kc, N, 8, dtype=i32),
        kf_kp_octave=z(Kc, N, dtype=i32), kf_kp_angle=z(Kc, N),
        kf_kp_valid=z(Kc, N, dtype=torch.bool),
        kf_kp_pt=torch.full((Kc, N), -1, dtype=i32, device=device),
        obs_kf=z(O, dtype=i32), obs_pt=z(O, dtype=i32), obs_kp=z(O, dtype=i32),
        obs_uv=z(O, 2), obs_inv_sigma2=torch.ones(O, device=device),
        obs_valid=z(O, dtype=torch.bool),
    )


def free_slots(valid, n: int) -> np.ndarray:
    """The first ``n`` free (invalid) slot indices, on the host; fewer
    when capacity is exhausted. ``valid``: a tensor or numpy bool array."""
    if isinstance(valid, torch.Tensor):
        valid = valid.cpu().numpy()
    return np.where(~np.asarray(valid))[0][:n]


def update_normal_and_depth(m: SlamMap, scale_factor: float, n_levels: int) -> SlamMap:
    """Every point's mean viewing direction and scale-distance envelope from
    the observation list, the batch ``MapPoint::UpdateNormalAndDepth``:

    normal = the mean over its observations of the unit vector from the
             keyframe's optical centre to the point;
    dmax   = the largest dist * scale^octave over its observations;
    dmin   = dmax / scale^(n_levels - 1).

    Points with no valid observation keep their statistics (dmax == 0
    disables the frustum gates). The direction sums are sorted segment
    sums (``optim.segment``: the same bits on every run); the segment max
    is ``scatter_reduce_("amax")`` over zeros: candidates are >= 0."""
    P = m.point_capacity
    okf, opt = m.obs_kf.long(), m.obs_pt.long()
    ov = m.obs_valid & m.kf_valid[okf] & m.pt_valid[opt]
    centers = -torch.einsum("kij,ki->kj", m.kf_R, m.kf_t)    # [Kc, 3]
    view = m.pts[opt] - centers[okf]
    dist = torch.linalg.vector_norm(view, dim=-1)
    unit = view / dist.clamp_min(1e-9)[:, None]
    w = ov.to(torch.float32)
    sums = segment_sum(torch.cat([unit * w[:, None], w[:, None]], dim=1), segments(opt, P, ov))
    sum_dir, cnt = sums[:, :3], sums[:, 3]
    normal = sum_dir / cnt.clamp_min(1.0)[:, None]
    normal = normal / torch.linalg.vector_norm(normal, dim=-1, keepdim=True).clamp_min(1e-9)
    octv = m.kf_kp_octave[okf, m.obs_kp.long()].to(torch.float32)
    dmax_cand = torch.where(ov, dist * scale_factor ** octv, 0.0)
    dmax = torch.zeros(P, device=m.pts.device).scatter_reduce_(
        0, opt, dmax_cand, "amax", include_self=True)
    dmin = dmax / scale_factor ** (n_levels - 1)
    has = cnt > 0
    return m._replace(
        pt_normal=torch.where(has[:, None], normal, m.pt_normal),
        pt_dmin=torch.where(has, dmin, m.pt_dmin),
        pt_dmax=torch.where(has, dmax, m.pt_dmax),
    )


def apply_ba_result(m: SlamMap, res) -> SlamMap:
    """Adopt a ``bundle_adjust`` result: refined poses and points, and the
    outlier lifecycle: observations classified as outliers are invalidated,
    their points' observation counts drop, and the snapshots' keypoint ->
    point associations they carried are severed."""
    pruned = m.obs_valid & ~res.obs_inlier
    N = m.kp_capacity
    cell = m.obs_kf.long() * N + m.obs_kp.long()
    sever = torch.zeros(m.kf_kp_pt.numel(), dtype=torch.int32, device=cell.device)
    sever = sever.index_add_(0, cell, pruned.to(torch.int32)).view(m.kf_kp_pt.shape) > 0
    n_obs = m.n_obs.index_add(0, m.obs_pt.long(), -pruned.to(torch.int32))
    return m._replace(
        kf_R=res.kf_R, kf_t=res.kf_t, pts=res.pts,
        obs_valid=m.obs_valid & res.obs_inlier, n_obs=n_obs,
        kf_kp_pt=torch.where(sever, -1, m.kf_kp_pt),
    )
