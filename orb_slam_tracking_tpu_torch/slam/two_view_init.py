"""Two-view monocular initialization of an image pair: the per-pair body
that both of the JAX package's callers run (``examples/
demo_initialization.py`` and ``Tracker._try_initialize``).

Per pair:

    extract x2 (init_orb: twice the features) -> undistort -> match
    (search_for_initialization) -> compact_matches -> initialize_two_view

``TwoViewInitializer`` is an ``nn.Module`` holding the extractor's
constants for ``init_orb`` and ``K`` as buffers. On the card a pair
launches two FAST kernels, two moments kernels, two BRIEF kernels and one
fused Hamming row-minimum kernel (``hamming_gated_min``). Every match and
hypothesis count is a fixed capacity with a validity mask, so the pair
runs whether or not it has enough matches; ``success`` carries the
reference's 100-match gate.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import nn

from ..config import CameraConfig, InitConfig, MatcherConfig, OrbConfig
from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..geometry import camera
from ..geometry.twoview import TwoViewResult, initialize_two_view
from ..ops.extractor import ExtractorConstants, orb_extract
from ..ops.matcher import MatchResult, compact_matches, search_for_initialization
from ..types import Keypoints

__all__ = ["InitPairResult", "TwoViewInitializer"]


class InitPairResult(NamedTuple):
    kps1: Keypoints           # frame-1 keypoints
    kps2: Keypoints           # frame-2 keypoints
    matches: MatchResult      # frame-1 -> frame-2 matches
    pairs: torch.Tensor       # [cap, 2] int32 compacted (i1, i2)
    pair_valid: torch.Tensor  # [cap] bool
    two_view: TwoViewResult


class TwoViewInitializer(nn.Module):
    """Two-view initialization for one camera and configuration.

    ``forward(img1 [H, W], img2 [H, W], generator) -> InitPairResult``:
    ``orb_cfg`` is the init-time extractor (``SystemConfig.init_orb``);
    ``generator`` (on the module's device) draws the H and F hypotheses'
    uniforms, in that order.
    """

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                 matcher_cfg: MatcherConfig, init_cfg: InitConfig,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        self.cam_cfg = cam_cfg
        self.orb_cfg = orb_cfg
        self.matcher_cfg = matcher_cfg
        self.init_cfg = init_cfg
        full_f32(device)
        self.consts = ExtractorConstants(cam_cfg.height, cam_cfg.width,
                                         orb_cfg, device)
        self.register_buffer("K", camera.intrinsics_matrix(cam_cfg, device))

    def forward(self, img1: torch.Tensor, img2: torch.Tensor,
                generator: torch.Generator) -> InitPairResult:
        cam = self.cam_cfg
        k1 = orb_extract(img1, self.orb_cfg, self.consts)
        k2 = orb_extract(img2, self.orb_cfg, self.consts)
        un1 = camera.undistort_pixels(cam, k1.xy)
        un2 = camera.undistort_pixels(cam, k2.xy)
        res = search_for_initialization(
            k1.desc, un1, k1.octave, k1.angle_deg, k1.valid,
            k2.desc, un2, k2.octave, k2.angle_deg, k2.valid, self.matcher_cfg)
        pairs, pv = compact_matches(res.matches12, self.matcher_cfg.max_matches)
        shape = (self.init_cfg.ransac_iterations, 8)
        u_h = torch.rand(shape, generator=generator, device=self.K.device)
        u_f = torch.rand(shape, generator=generator, device=self.K.device)
        tv = initialize_two_view(un1[pairs[:, 0].long()], un2[pairs[:, 1].long()],
                                 pv, self.K, u_h, u_f, self.init_cfg)
        return InitPairResult(kps1=k1, kps2=k2, matches=res, pairs=pairs,
                              pair_valid=pv, two_view=tv)
