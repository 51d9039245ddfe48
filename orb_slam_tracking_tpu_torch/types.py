"""Fixed-capacity keypoint container and the per-image frame record
(counterpart of ``types.py``).

Rows with ``valid == False`` are padding; the capacity is
``OrbConfig.max_keypoints``. Descriptors are ``[N, 8]`` int32 carrying
the same bits as the JAX package's uint32 words.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

__all__ = ["Frame", "Keypoints"]


class Keypoints(NamedTuple):
    xy: torch.Tensor         # [N, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor   # [N] float32, FAST score
    angle_deg: torch.Tensor  # [N] float32, IC orientation in degrees [0, 360)
    octave: torch.Tensor     # [N] int32, pyramid level
    size: torch.Tensor       # [N] float32, PATCH_SIZE * level scale
    desc: torch.Tensor       # [N, 8] int32, packed 256-bit descriptor
    valid: torch.Tensor      # [N] bool

    def count(self) -> torch.Tensor:
        """Number of valid keypoints, as a 0-d int32 tensor (no host sync)."""
        return self.valid.sum(dim=-1, dtype=torch.int32)


class Frame(NamedTuple):
    """One image's keypoints, their undistorted coordinates and its pose
    (world-to-camera), as the reference's ``Frame`` (``Frame.cpp:40-87``)."""

    frame_id: torch.Tensor   # [] int32
    timestamp: torch.Tensor  # [] float32
    kps: Keypoints           # keypoints, distorted (raw) coords
    xy_un: torch.Tensor      # [N, 2] float32, undistorted level-0 coords
    R_cw: torch.Tensor       # [3, 3] world-to-camera rotation
    t_cw: torch.Tensor       # [3] world-to-camera translation
