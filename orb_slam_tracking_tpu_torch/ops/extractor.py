"""ORB extraction entry point (counterpart of ``ops/extractor.py``).

``orb_extract`` takes the atlas path (``ops/atlas.py``), the JAX package's
default, or with ``use_atlas=False`` the per-level path here: per level
the FAST score (``fast_score``), the disc moments at the keypoints
(``moments_at``) and the descriptors (``brief_words``), each its own
kernel, so 3 launches a level where the atlas path makes 2 an
extraction. Both paths give identical keypoints: their levels come from
one resize, and every read stencil of a keypoint stays inside its level's
apron. Either path takes a detection mask and Harris ranking.

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
from .atlas import atlas_layout, orb_extract_atlas, pad_keypoints
from .brief import brief_words, rotated_pattern, sample_coords
from .fast import detect_from_score, fast_score
from .harris import harris_response
from .orientation import angles_from_moments, moments_at
from .pattern import EDGE_THRESHOLD, brief_pattern, umax_table
from .pyramid import build_pyramid, gauss_taps, gaussian_blur, mask_level, resize_matrix
from .select import select_level

__all__ = ["ExtractorConstants", "orb_extract", "orb_extract_levels"]


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


def orb_extract_levels(image: torch.Tensor, cfg: OrbConfig, consts: ExtractorConstants,
                       mask: Optional[torch.Tensor] = None) -> Keypoints:
    """The per-level path (``ops/extractor.py:66-124``): each padded level
    detected, selected, oriented and described on its own. The angles and
    the rotated pattern are elementwise, and are taken for all levels'
    keypoints in one call each, as on the atlas path: a CPU's vector math
    may round an element by where it falls in the batch."""
    budgets = cfg.features_per_level()
    scales = cfg.level_scales()
    harris = cfg.score_type == "harris"
    pad = EDGE_THRESHOLD
    levels = build_pyramid(image, consts.resize_mats, pad)
    xys, xs, resps, m10s, m01s, valids = [], [], [], [], [], []
    for lvl, padded in enumerate(levels):
        h, w = padded.shape[0] - 2 * pad, padded.shape[1] - 2 * pad
        score = detect_from_score(fast_score(padded, pad), cfg.ini_th_fast,
                                  cfg.min_th_fast, cfg.fast_cell_size, pad)
        if mask is not None:
            score = torch.where(mask_level(mask, h, w), score, 0.0)
        if harris:
            score = torch.where(score > 0.0, harris_response(padded, pad) + 1.0, 0.0)
        xy_l, resp, valid = select_level(score, budgets[lvl], cfg.select_cell_size)
        if harris:
            resp = torch.where(valid, resp - 1.0, resp)
        # the disc moments at the keypoints, in place of the JAX package's
        # dense moment maps read there: the same sums (ops/orientation.py)
        m10, m01 = moments_at(padded, xy_l[:, 1].to(torch.int32) + pad,
                              xy_l[:, 0].to(torch.int32) + pad, consts.umax)
        xys.append(xy_l)
        xs.append(xy_l * scales[lvl])
        resps.append(resp)
        m10s.append(m10)
        m01s.append(m01)
        valids.append(valid)
    angle = angles_from_moments(torch.cat(m10s), torch.cat(m01s))
    rx, ry = rotated_pattern(angle, consts.pattern_xy)
    descs = []
    start = 0
    for padded, xy_l in zip(levels, xys):
        rows = slice(start, start + xy_l.shape[0])
        start += xy_l.shape[0]
        # the reference blurs into CV_8U: its bits compare integer intensities
        blurred = torch.round(gaussian_blur(padded, consts.gauss))
        sy, sx = sample_coords(xy_l, rx[rows], ry[rows], *blurred.shape, pad)
        descs.append(brief_words(blurred, sy, sx))
    return pad_keypoints(cfg, torch.cat(xs), torch.cat(resps), angle,
                         torch.cat(descs), torch.cat(valids))


def orb_extract(image: torch.Tensor, cfg: OrbConfig,
                consts: Optional[ExtractorConstants] = None,
                mask: Optional[torch.Tensor] = None) -> Keypoints:
    """ORB keypoints + descriptors of ``image [H, W] float32``, at capacity
    ``cfg.max_keypoints`` (invalid rows are padding). Images ``[B, H, W]``
    give ``Keypoints`` with a leading [B] (atlas path, FAST ranking, no
    mask), from one launch of each extraction kernel for the batch.

    ``mask`` ([H, W], nonzero = detect) restricts detection, as the
    reference functor's mask argument (``ORBextractor.hpp:83-85``);
    ``cfg.score_type == "harris"`` ranks the FAST corners by the Harris
    measure, and ``response`` then carries the Harris value."""
    if consts is None:
        consts = ExtractorConstants(image.shape[-2], image.shape[-1], cfg,
                                    image.device)
    if image.dim() == 3 and not cfg.use_atlas:
        raise ValueError("the batched extraction takes the atlas path")
    if mask is not None and tuple(mask.shape) != tuple(image.shape):
        raise ValueError(f"mask {tuple(mask.shape)} does not match the image "
                         f"{tuple(image.shape)}")
    if cfg.use_atlas:
        return orb_extract_atlas(image, cfg, consts, mask)
    return orb_extract_levels(image, cfg, consts, mask)
