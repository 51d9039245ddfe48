"""Atlas ORB extraction: all pyramid levels packed into one canvas
(counterpart of ``ops/atlas.py``).

Each level carries its own 19-px reflect apron and the blocks are stacked
vertically, so the FAST score and the blur each run once over the canvas,
and the orientation and the descriptor once over all keypoints.
Per-level work (eligibility border, the dual-threshold cell fallback, NMS,
the detection mask, budgeted selection) runs on static slices of the
canvas score map. Under Harris ranking the response is taken once on the
canvas and read per level.

The disc moments are taken at the selected keypoints only, the JAX
package's ``ORB_TPU_KP_MOMENTS=1`` branch, not by its default dense
``moment_maps`` canvas pass: the two give identical angles, and the
keypoint path takes less device time on the H100 (PERF.md). One call,
``orient_describe``, takes the moments, the angle and the descriptor of
every keypoint.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import OrbConfig
from ..types import Keypoints
from .describe import orient_describe
from .fast import detect_from_score, fast_score
from .harris import harris_response
from .pattern import EDGE_THRESHOLD, PATCH_SIZE
from .pyramid import build_pyramid, gaussian_blur, mask_level
from .select import select_level

__all__ = ["AtlasLayout", "atlas_layout", "build_atlas", "orb_extract_atlas",
           "pad_keypoints"]

_PAD = EDGE_THRESHOLD  # 19-px apron per block (ORBextractor.cpp:90)


class AtlasLayout(NamedTuple):
    level_shapes: Tuple[Tuple[int, int], ...]  # interior (h_l, w_l)
    row_offsets: Tuple[int, ...]               # canvas row of block l's top
    canvas_h: int
    canvas_w: int                              # 128-aligned, as the JAX canvas


@functools.lru_cache(maxsize=32)
def atlas_layout(h: int, w: int, cfg: OrbConfig) -> AtlasLayout:
    shapes = cfg.level_shapes(h, w)
    offsets = []
    row = 0
    for (hl, _) in shapes:
        offsets.append(row)
        row += hl + 2 * _PAD
    wc = max(wl for (_, wl) in shapes) + 2 * _PAD
    wc = ((wc + 127) // 128) * 128
    return AtlasLayout(tuple(shapes), tuple(offsets), row, wc)


def build_atlas(image: torch.Tensor, lay: AtlasLayout,
                resize_mats: Sequence[Tuple[torch.Tensor, torch.Tensor]]
                ) -> torch.Tensor:
    """[H, W] image -> the stacked canvas [canvas_h, canvas_w]: the padded
    levels of ``build_pyramid``, each right-padded with zeros.

    ``resize_mats[l - 1]`` is the (M_h, M_w) pair taking level l-1 to l.
    """
    blocks: List[torch.Tensor] = [
        F.pad(padded, (0, lay.canvas_w - padded.shape[1]))
        for padded in build_pyramid(image, resize_mats, _PAD)]
    return torch.cat(blocks, dim=0)


def pad_keypoints(cfg: OrbConfig, xy: torch.Tensor, response: torch.Tensor,
                  angle: torch.Tensor, desc: torch.Tensor, valid: torch.Tensor
                  ) -> Keypoints:
    """The levels' keypoints, level after level, each level's rows its
    budget, padded with invalid rows to ``cfg.max_keypoints``."""
    budgets = cfg.features_per_level()
    scales = cfg.level_scales()
    dev = xy.device
    octave = torch.cat([torch.full((b,), lvl, dtype=torch.int32, device=dev)
                        for lvl, b in enumerate(budgets)])
    size = torch.cat([torch.full((b,), PATCH_SIZE * scales[lvl], dtype=torch.float32,
                                 device=dev) for lvl, b in enumerate(budgets)])
    n = xy.shape[0]
    cap = cfg.max_keypoints
    if cap < n:
        raise ValueError(f"max_keypoints {cap} < total budget {n}")
    pad_n = cap - n
    return Keypoints(
        xy=F.pad(xy, (0, 0, 0, pad_n)),
        response=F.pad(response, (0, pad_n)),
        angle_deg=F.pad(angle, (0, pad_n)),
        octave=F.pad(octave, (0, pad_n)),
        size=F.pad(size, (0, pad_n)),
        desc=F.pad(desc, (0, 0, 0, pad_n)),
        valid=F.pad(valid, (0, pad_n)),
    )


def extract_from_canvas(canvas: torch.Tensor, lay: AtlasLayout,
                        cfg: OrbConfig, gauss: torch.Tensor,
                        pattern_xy: torch.Tensor, umax: Sequence[int],
                        mask: Optional[torch.Tensor] = None) -> Keypoints:
    """Detect, select, orient and describe on a built canvas; ``mask``
    [H, W] (nonzero = detect) restricts detection at level 0's
    resolution."""
    budgets = cfg.features_per_level()
    scales = cfg.level_scales()
    harris = cfg.score_type == "harris"

    score_c = fast_score(canvas, _PAD)
    blurred_c = gaussian_blur(canvas, gauss)
    if harris:
        harris_c = harris_response(canvas, _PAD)

    xy_atlas, xs, resps, valids = [], [], [], []
    for lvl, ((hl, wl), off) in enumerate(zip(lay.level_shapes, lay.row_offsets)):
        det = detect_from_score(score_c[off: off + hl, :wl], cfg.ini_th_fast,
                                cfg.min_th_fast, cfg.fast_cell_size, _PAD)
        if mask is not None:
            det = torch.where(mask_level(mask, hl, wl), det, 0.0)
        if harris:
            det = torch.where(det > 0.0, harris_c[off: off + hl, :wl] + 1.0, 0.0)
        xy_l, resp, valid = select_level(det, budgets[lvl], cfg.select_cell_size)
        if harris:
            resp = torch.where(valid, resp - 1.0, resp)
        xy_atlas.append(torch.stack([xy_l[:, 0], xy_l[:, 1] + float(off)], dim=-1))
        xs.append(xy_l * scales[lvl])
        resps.append(resp)
        valids.append(valid)

    xy_c = torch.cat(xy_atlas)
    # absolute canvas pixel of each keypoint (atlas.py:191-193)
    yc = xy_c[:, 1].to(torch.int32) + _PAD
    xc = xy_c[:, 0].to(torch.int32) + _PAD
    angle, desc = orient_describe(canvas, blurred_c, yc, xc, xy_c, pattern_xy, umax)
    return pad_keypoints(cfg, torch.cat(xs), torch.cat(resps), angle, desc,
                         torch.cat(valids))


def orb_extract_atlas(image: torch.Tensor, cfg: OrbConfig, consts,
                      mask: Optional[torch.Tensor] = None) -> Keypoints:
    """Atlas ORB extraction of ``image [H, W] float32``."""
    lay = atlas_layout(image.shape[0], image.shape[1], cfg)
    canvas = build_atlas(image, lay, consts.resize_mats)
    return extract_from_canvas(canvas, lay, cfg, consts.gauss,
                               consts.pattern_xy, consts.umax, mask)
