"""ORB extraction entry point (counterpart of ``ops/extractor.py``).

``orb_extract`` dispatches to the atlas path, the JAX package's default.
The per-level path (``use_atlas=False``), the detection mask and Harris
ranking are not ported yet (ROADMAP.md, queue A, item 2 "per-level
extractor path, mask and Harris") and raise ``NotImplementedError``.

The per-configuration constants (resize matrices, Gaussian taps, BRIEF
pattern, ``umax``) are built once, as the buffers of an
``ExtractorConstants`` module; ``slam.fused_step.TrackingStep`` holds one.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..config import OrbConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..types import Keypoints
from .atlas import atlas_layout, orb_extract_atlas
from .pattern import brief_pattern, umax_table
from .pyramid import gauss_taps, resize_matrix

__all__ = ["ExtractorConstants", "orb_extract"]


class ExtractorConstants(nn.Module):
    """The extractor's constants for one image size and ``OrbConfig``, as
    buffers on ``device``: ``resize_h{l-1}``/``resize_w{l-1}`` take level
    l-1 to level l, ``gauss`` [7] are the blur taps and ``pattern_xy``
    [2, 512] the BRIEF offsets (x row, y row). ``umax``, the disc
    half-widths, shapes the moment program's slices, so it stays a host
    tuple: reading it from the device would sync every frame."""

    def __init__(self, height: int, width: int, cfg: OrbConfig,
                 device: torch.device | str = DEFAULT_DEVICE):
        super().__init__()
        device = resolve_device(device)
        shapes = atlas_layout(height, width, cfg).level_shapes
        self.n_resize = len(shapes) - 1
        for i, ((h0, w0), (h1, w1)) in enumerate(zip(shapes[:-1], shapes[1:])):
            self.register_buffer(
                f"resize_h{i}", torch.tensor(resize_matrix(h0, h1), device=device))
            self.register_buffer(
                f"resize_w{i}", torch.tensor(resize_matrix(w0, w1), device=device))
        self.register_buffer("gauss", gauss_taps(device=device))
        pat = brief_pattern()
        self.register_buffer("pattern_xy", torch.tensor(
            np.stack([np.concatenate([pat[:, 0], pat[:, 2]]),
                      np.concatenate([pat[:, 1], pat[:, 3]])]),
            dtype=torch.float32, device=device))
        self.umax: Tuple[int, ...] = tuple(int(u) for u in umax_table())

    @property
    def resize_mats(self) -> Tuple[Tuple[torch.Tensor, torch.Tensor], ...]:
        return tuple((getattr(self, f"resize_h{i}"), getattr(self, f"resize_w{i}"))
                     for i in range(self.n_resize))


def orb_extract(image: torch.Tensor, cfg: OrbConfig,
                consts: Optional[ExtractorConstants] = None,
                mask: Optional[torch.Tensor] = None) -> Keypoints:
    """ORB keypoints + descriptors of ``image [H, W] float32``, at capacity
    ``cfg.max_keypoints`` (invalid rows are padding)."""
    if not cfg.use_atlas:
        raise NotImplementedError(
            "use_atlas=False: the per-level extractor path is not ported "
            "yet (ROADMAP.md queue A item 2)")
    if mask is not None:
        raise NotImplementedError(
            "detection mask is not ported yet (ROADMAP.md queue A item 2)")
    if cfg.score_type == "harris":
        raise NotImplementedError(
            "score_type='harris' is not ported yet (ROADMAP.md queue A item 2)")
    if consts is None:
        consts = ExtractorConstants(image.shape[0], image.shape[1], cfg,
                                    image.device)
    return orb_extract_atlas(image, cfg, consts)
