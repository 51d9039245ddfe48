"""Configuration of the tracking slice, as frozen dataclasses.

These are the port's own copies of the JAX package's ``CameraConfig``,
``OrbConfig``, ``MatcherConfig``, ``InitConfig``, ``TrackerConfig`` and
``SystemConfig``, with the same names, defaults, checks and derived
shapes; ``TrackerConfig`` is copied whole, the others are cut to the
fields the port reads. The port imports nothing of the JAX package, so it cannot share
them; ``tests/test_torch_track.py`` holds the two sets equal. The YAML
loader and the other fields come with the slices that use them.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

__all__ = ["CameraConfig", "InitConfig", "MatcherConfig", "OrbConfig",
           "SystemConfig", "TrackerConfig"]


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole camera with Brown radial-tangential distortion; the image
    size is part of the config because every shape downstream is fixed."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    width: int = 640
    height: int = 480

    def __post_init__(self):
        if self.fx <= 0 or self.fy <= 0:
            raise ValueError(f"focal lengths must be positive, got {self.fx}, {self.fy}")
        if self.width <= 0 or self.height <= 0:
            raise ValueError("image size must be positive")

    @property
    def has_distortion(self) -> bool:
        return any(abs(v) > 0 for v in (self.k1, self.k2, self.p1, self.p2))


@dataclasses.dataclass(frozen=True)
class OrbConfig:
    """ORB extraction operating point: 1000 features, scale 1.2, 8 levels,
    FAST thresholds 20/7. ``max_keypoints`` is the fixed capacity of every
    keypoint tensor (0 = the next multiple of 256 >= ``n_features``)."""

    n_features: int = 1000
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: int = 20
    min_th_fast: int = 7
    score_type: str = "fast"      # "harris" is not ported yet
    max_keypoints: int = 0
    fast_cell_size: int = 35      # dual-threshold fallback cell, px
    select_cell_size: int = 12    # top-1-per-cell selection grid, px
    use_atlas: bool = True        # False (per-level path) is not ported yet

    def __post_init__(self):
        if self.n_levels < 1:
            raise ValueError("n_levels must be >= 1")
        if self.scale_factor <= 1.0:
            raise ValueError("scale_factor must be > 1")
        if self.score_type not in ("fast", "harris"):
            raise ValueError(
                f"score_type must be 'fast' or 'harris', got {self.score_type!r}")
        if self.max_keypoints == 0:
            cap = ((self.n_features + 255) // 256) * 256
            object.__setattr__(self, "max_keypoints", cap)
        if self.max_keypoints < self.n_features:
            raise ValueError("max_keypoints must be >= n_features")

    def features_per_level(self) -> Tuple[int, ...]:
        """Geometric per-level budget ``n*(1-1/s)/(1-(1/s)^L)`` at level 0,
        scaled by 1/s per level, the remainder to the top level."""
        inv = 1.0 / self.scale_factor
        n_desired = self.n_features * (1 - inv) / (1 - inv ** self.n_levels)
        budget = []
        total = 0
        for _ in range(self.n_levels - 1):
            n = int(round(n_desired))
            budget.append(n)
            total += n
            n_desired *= inv
        budget.append(max(self.n_features - total, 0))
        return tuple(budget)

    def level_scales(self) -> Tuple[float, ...]:
        return tuple(self.scale_factor ** i for i in range(self.n_levels))

    def level_shapes(self, height: int, width: int) -> Tuple[Tuple[int, int], ...]:
        """(H, W) of each pyramid level, rounded like ``cv::resize``."""
        return tuple((int(round(height / s)), int(round(width / s)))
                     for s in self.level_scales())


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching: the ratio test, rotation histogram and Hamming
    thresholds of initialization (``th_low``) and tracking (``th_high``),
    the initialization search window in px and the fixed capacity of the
    compacted match list."""

    nn_ratio: float = 0.9
    check_orientation: bool = True
    th_low: int = 50
    th_high: int = 100
    histo_length: int = 30
    window_size: int = 100
    max_matches: int = 2048


@dataclasses.dataclass(frozen=True)
class InitConfig:
    """Two-view initialization: RANSAC hypotheses per model (200 as in
    tracking, the demo uses 2000), the acceptance gates, the H/F selection
    threshold on RH = SH / (SH + SF). The chi-square thresholds are the
    scores' constants, as in the JAX package."""

    sigma: float = 1.0
    ransac_iterations: int = 200
    min_matches: int = 100
    min_triangulated: int = 50
    min_parallax_deg: float = 1.0
    rh_threshold: float = 0.40


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """The tracking loop's knobs, field for field the JAX package's: the
    motion model and keyframe bounds, the stage-1 projection radius (scaled
    per keypoint octave) and the tight re-match radius, the pose LM's
    rounds, the map capacities, local BA, the map lifecycle (covisibility
    triangulation, fusion, point and keyframe culling) and relocalization.

    BoW (``use_bow``, ``vocab_path``; ``bow_branching`` and ``bow_depth``
    size the one-frame vocabulary trained when no artifact is found) and
    loop closing (``use_loop_closing``, the ``loop_*`` and
    ``pose_graph_iterations`` fields) are on by default, as in the JAX
    package; the device mapping loop runs with both off. Local BA
    always takes the scatter formulation (``ba_segment_mode`` "auto" or
    "scatter"); ``lost_recovery_radius_scale`` is read by the device
    mapping loop (``slam/device_mapping.py``, its LOST-recovery tier), as
    in the JAX package."""

    use_motion_model: bool = True
    min_frames: int = 0
    max_frames: int = 18  # 18 * fps / 30 at fps=30 (Settings.hpp:46)
    projection_radius: float = 15.0
    local_map_radius: float = 3.0
    min_tracked_inliers: int = 10
    lost_recovery_radius_scale: float = 3.0
    pose_opt_rounds: int = 2
    pose_opt_iters: int = 6
    huber_delta: float = math.sqrt(5.991)
    # map capacities (static shapes)
    max_keyframes: int = 64
    max_map_points: int = 8192
    # bag-of-words place recognition
    use_bow: bool = True
    bow_branching: int = 8
    bow_depth: int = 3
    vocab_path: Optional[str] = "bundled"
    # local BA
    ba_window: int = 20
    ba_iterations: int = 10
    ba_early_stop_rel: float = 1e-4
    ba_segment_mode: str = "auto"
    # map lifecycle (ORB-SLAM LocalMapping semantics)
    covis_keyframes: int = 3
    covis_min_shared: int = 15
    fuse_radius_px: float = 2.0
    cull_min_obs: int = 3
    cull_age_kfs: int = 3
    cull_found_ratio: float = 0.25
    cull_min_visible: int = 8
    kf_redundancy_frac: float = 0.9
    reloc_bow_candidates: int = 5
    # loop closing
    use_loop_closing: bool = True
    loop_min_frame_gap: int = 60
    loop_consistency_th: int = 3
    loop_min_inliers: int = 20
    loop_max_sim3_candidates: int = 5
    loop_covis_edge_min_shared: int = 30
    pose_graph_iterations: int = 15
    loop_fuse_radius_px: float = 8.0
    loop_sim3_grow_radius_px: float = 7.5
    loop_global_ba_iterations: int = 8


@dataclasses.dataclass(frozen=True)
class SystemConfig:
    camera: CameraConfig
    orb: OrbConfig = OrbConfig()
    matcher: MatcherConfig = MatcherConfig()
    init: InitConfig = InitConfig()
    tracker: TrackerConfig = TrackerConfig()

    @property
    def init_orb(self) -> OrbConfig:
        """Init-time extractor with twice the features (the reference's
        ``tracking.cpp:17-23``), capacity re-derived."""
        return dataclasses.replace(
            self.orb, n_features=2 * self.orb.n_features, max_keypoints=0)
