"""The WORKING-state tracking step (counterpart of ``slam/fused_step.py``).

Per frame:

    extract -> undistort -> project the map under the predicted pose and
    match -> pose-only LM -> tight re-match from the refined pose -> LM

``TrackingStep`` is an ``nn.Module`` whose buffers (in its
``ExtractorConstants`` submodule) hold every per-configuration constant
(resize matrices, Gaussian taps, BRIEF pattern), built once. The step has
fixed shapes and validity masks and never syncs the host, so it can later
be captured as one CUDA graph. On the card it launches one FAST kernel,
one moments kernel, one BRIEF kernel and two fused Hamming row-minimum
kernels (``hamming_gated_min``, one per match).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..geometry import camera
from ..ops.extractor import ExtractorConstants, orb_extract
from ..ops.proj_matcher import search_by_projection
from ..optim.pose_opt import optimize_pose
from ..types import Keypoints

__all__ = ["FusedStepResult", "TrackingStep"]


class FusedStepResult(NamedTuple):
    R: torch.Tensor             # [3, 3] optimised world-to-camera
    t: torch.Tensor             # [3]
    n_inliers: torch.Tensor     # [] int32
    n_matches1: torch.Tensor    # [] stage-1 projection matches
    n_matches2: torch.Tensor    # [] stage-2 (tight) matches
    n_kps: torch.Tensor         # [] extracted keypoints
    kp_for_point: torch.Tensor  # [P] final association
    inlier: torch.Tensor        # [P] final pose-opt inlier mask
    visible: torch.Tensor       # [P] frustum visibility
    kps: Keypoints              # the extracted keypoints
    xy_un: torch.Tensor         # [N, 2] undistorted keypoint pixels


class TrackingStep(nn.Module):
    """The fused tracking step for one camera and configuration.

    ``forward(image [H,W], map_pts [P,3], map_desc [P,8] int32,
    map_valid [P], map_normal [P,3], map_dmin [P], map_dmax [P],
    R_pred, t_pred, R0, t0, K) -> FusedStepResult``: ``R_pred/t_pred``
    centre the stage-1 search window, ``R0/t0`` seed the optimiser.
    ``radius_scale`` widens the stage-1 window.
    """

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                 matcher_cfg: MatcherConfig, tracker_cfg: TrackerConfig,
                 radius_scale: float = 1.0,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cam_cfg = cam_cfg
        self.orb_cfg = orb_cfg
        self.matcher_cfg = matcher_cfg
        self.tracker_cfg = tracker_cfg
        self.radius = tracker_cfg.projection_radius * radius_scale
        full_f32(device)
        self.consts = ExtractorConstants(cam_cfg.height, cam_cfg.width,
                                         orb_cfg, device)

    def forward(self, image, map_pts, map_desc, map_valid, map_normal,
                map_dmin, map_dmax, R_pred, t_pred, R0, t0, K
                ) -> FusedStepResult:
        cam, ocfg, tcfg = self.cam_cfg, self.orb_cfg, self.tracker_cfg
        scale = ocfg.scale_factor
        kps = orb_extract(image, ocfg, self.consts)
        xy_un = camera.undistort_pixels(cam, kps.xy)

        def match(R, t, rad):
            return search_by_projection(
                map_pts, map_desc, map_valid, R, t, K,
                kps.desc, xy_un, kps.valid, rad, self.matcher_cfg,
                cam.width, cam.height, kp_octave=kps.octave,
                scale_factor=scale, pt_normal=map_normal, pt_dmin=map_dmin,
                pt_dmax=map_dmax, n_levels=ocfg.n_levels)

        def optimize(R, t, pm):
            safe = pm.kp_for_point.clamp_min(0).to(torch.int64)
            inv_s2 = 1.0 / scale ** (2.0 * kps.octave[safe].to(torch.float32))
            return optimize_pose(
                R, t, map_pts, xy_un[safe], inv_s2, pm.kp_for_point >= 0, K,
                rounds=tcfg.pose_opt_rounds,
                iters_per_round=tcfg.pose_opt_iters)

        pm1 = match(R_pred, t_pred, self.radius)
        res1 = optimize(R0, t0, pm1)
        pm2 = match(res1.R, res1.t, tcfg.local_map_radius)
        res2 = optimize(res1.R, res1.t, pm2)
        return FusedStepResult(
            R=res2.R, t=res2.t, n_inliers=res2.n_inliers,
            n_matches1=pm1.n_matches, n_matches2=pm2.n_matches,
            n_kps=kps.count(), kp_for_point=pm2.kp_for_point,
            inlier=res2.inlier, visible=pm2.visible, kps=kps, xy_un=xy_un)
