"""Atlas ORB extraction: all pyramid levels packed into one canvas
(counterpart of ``ops/atlas.py``).

Each level carries its own 19-px reflect apron and the blocks are stacked
vertically, so the FAST score and the blur each run once over the canvas,
and the orientation and the descriptor once over all keypoints.
Per-level work (eligibility border, the dual-threshold cell fallback, NMS,
budgeted selection) runs on static slices of the canvas score map.

The disc moments are taken at the selected keypoints only, the JAX
package's ``ORB_TPU_KP_MOMENTS=1`` branch, not by its default dense
``moment_maps`` canvas pass: the two give identical angles, and the
keypoint path takes less device time on the H100 (PERF.md). One call,
``orient_describe``, takes the moments, the angle and the descriptor of
every keypoint.
"""

from __future__ import annotations

import functools
from typing import List, NamedTuple, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..config import OrbConfig
from ..types import Keypoints
from .describe import orient_describe
from .fast import cell_reduce_max, fast_score
from .pattern import EDGE_THRESHOLD, PATCH_SIZE
from .pyramid import gaussian_blur, reflect_pad, resize
from .select import select_level

__all__ = ["AtlasLayout", "atlas_layout", "build_atlas", "orb_extract_atlas"]

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
    """[H, W] image -> the stacked canvas [canvas_h, canvas_w].

    ``resize_mats[l - 1]`` is the (M_h, M_w) pair taking level l-1 to l.
    """
    blocks: List[torch.Tensor] = []
    cur = image
    for lvl in range(len(lay.level_shapes)):
        if lvl > 0:
            cur = resize(cur, *resize_mats[lvl - 1])
        padded = reflect_pad(cur, _PAD)
        blocks.append(F.pad(padded, (0, lay.canvas_w - padded.shape[1])))
    return torch.cat(blocks, dim=0)


def _detect_slice(score: torch.Tensor, ini_th: int, min_th: int,
                  cell_size: int) -> torch.Tensor:
    """Border mask, dual-threshold cell fallback and 3x3 NMS on a
    level-aligned score slice [h_l, w_l]."""
    h, w = score.shape
    b = _PAD - 3
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    region = (ys >= b) & (ys < h - b) & (xs >= b) & (xs < w - b)
    score = torch.where(region, score, 0.0)

    corner_hi = score > ini_th
    corner_lo = score > min_th
    cell_max = cell_reduce_max(torch.where(corner_hi, score, 0.0), cell_size)
    keep = corner_hi | (corner_lo & ~(cell_max > ini_th))
    score = torch.where(keep, score, 0.0)

    # 3x3 max with -inf outside, as reduce_window "SAME"
    pooled = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where((score >= pooled) & (score > 0.0), score, 0.0)


def extract_from_canvas(canvas: torch.Tensor, lay: AtlasLayout,
                        cfg: OrbConfig, gauss: torch.Tensor,
                        pattern_xy: torch.Tensor, umax: Sequence[int]) -> Keypoints:
    """Detect, select, orient and describe on a built canvas."""
    budgets = cfg.features_per_level()
    scales = cfg.level_scales()

    score_c = fast_score(canvas, _PAD)
    blurred_c = gaussian_blur(canvas, gauss)

    xy_atlas, xs, resps, octs, sizes, valids = [], [], [], [], [], []
    for lvl, ((hl, wl), off) in enumerate(zip(lay.level_shapes, lay.row_offsets)):
        det = _detect_slice(score_c[off: off + hl, :wl], cfg.ini_th_fast,
                            cfg.min_th_fast, cfg.fast_cell_size)
        xy_l, resp, valid = select_level(det, budgets[lvl], cfg.select_cell_size)
        xy_atlas.append(torch.stack([xy_l[:, 0], xy_l[:, 1] + float(off)], dim=-1))
        xs.append(xy_l * scales[lvl])
        resps.append(resp)
        octs.append(torch.full((budgets[lvl],), lvl, dtype=torch.int32,
                               device=canvas.device))
        sizes.append(torch.full((budgets[lvl],), PATCH_SIZE * scales[lvl],
                                dtype=torch.float32, device=canvas.device))
        valids.append(valid)

    xy_c = torch.cat(xy_atlas)
    # absolute canvas pixel of each keypoint (atlas.py:191-193)
    yc = xy_c[:, 1].to(torch.int32) + _PAD
    xc = xy_c[:, 0].to(torch.int32) + _PAD
    angle, desc = orient_describe(canvas, blurred_c, yc, xc, xy_c, pattern_xy, umax)

    n = xy_c.shape[0]
    cap = cfg.max_keypoints
    if cap < n:
        raise ValueError(f"max_keypoints {cap} < total budget {n}")
    pad_n = cap - n
    return Keypoints(
        xy=F.pad(torch.cat(xs), (0, 0, 0, pad_n)),
        response=F.pad(torch.cat(resps), (0, pad_n)),
        angle_deg=F.pad(angle, (0, pad_n)),
        octave=F.pad(torch.cat(octs), (0, pad_n)),
        size=F.pad(torch.cat(sizes), (0, pad_n)),
        desc=F.pad(desc, (0, 0, 0, pad_n)),
        valid=F.pad(torch.cat(valids), (0, pad_n)),
    )


def orb_extract_atlas(image: torch.Tensor, cfg: OrbConfig,
                      consts) -> Keypoints:
    """Atlas ORB extraction of ``image [H, W] float32``."""
    lay = atlas_layout(image.shape[0], image.shape[1], cfg)
    canvas = build_atlas(image, lay, consts.resize_mats)
    return extract_from_canvas(canvas, lay, cfg, consts.gauss,
                               consts.pattern_xy, consts.umax)
