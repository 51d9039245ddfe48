"""Frame construction and area queries (counterpart of ``slam/frame.py``).

``make_frame`` extracts, undistorts and packages a ``types.Frame``, as the
reference's ``Frame`` constructor (``Frame.cpp:40-82``);
``features_in_area`` is ``GetFeaturesInArea`` (``Frame.cpp:163-206``) as a
mask over the fixed keypoint rows in place of the 64x48 grid lookup, the
test the matchers make internally.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import CameraConfig, OrbConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..geometry import camera
from ..ops.extractor import orb_extract
from ..types import Frame, Keypoints

__all__ = ["make_frame", "features_in_area"]


def make_frame(image, frame_id: int, timestamp: float, orb_cfg: OrbConfig,
               cam: CameraConfig, device: torch.device | str = DEFAULT_DEVICE) -> Frame:
    """Extract the keypoints of ``image`` [H, W], undistort them, and package
    a Frame with the identity pose on ``device``."""
    device = resolve_device(device)
    img = torch.as_tensor(np.asarray(image, np.float32), device=device)
    kps = orb_extract(img, orb_cfg)
    return Frame(
        frame_id=torch.tensor(frame_id, dtype=torch.int32, device=device),
        timestamp=torch.tensor(timestamp, dtype=torch.float32, device=device),
        kps=kps,
        xy_un=camera.undistort_pixels(cam, kps.xy),
        R_cw=torch.eye(3, device=device),
        t_cw=torch.zeros(3, device=device),
    )


def features_in_area(kps: Keypoints, xy_un: torch.Tensor, x, y, r,
                     min_level: int = -1, max_level: int = -1) -> torch.Tensor:
    """Bool mask of the valid keypoints inside the square window of radius
    ``r`` round (x, y), optionally in an octave range (a negative bound is
    open, the reference's default)."""
    m = kps.valid & ((xy_un[:, 0] - x).abs() < r) & ((xy_un[:, 1] - y).abs() < r)
    if min_level >= 0:
        m = m & (kps.octave >= min_level)
    if max_level >= 0:
        m = m & (kps.octave <= max_level)
    return m
