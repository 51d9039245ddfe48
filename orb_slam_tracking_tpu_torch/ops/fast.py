"""FAST-9/16 corner score (counterpart of ``ops/fast.py``).

``fast_score`` is the wrapper of the CUDA kernel ``csrc/fast_score.cu``
(which replaces the TPU kernel ``fast_score_pallas``); on a CPU tensor it
runs ``fast_score_reference``, the plain PyTorch version of the same
function. ``fast_score.launches`` counts the kernel's launches.
``detect_from_score`` is the rest of the JAX package's ``detect_level``:
the border mask, the dual-threshold cell fallback and 3x3 NMS on a
level's score map, for either extraction path.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .pattern import EDGE_THRESHOLD

__all__ = ["RING_OFFSETS", "fast_score", "fast_score_reference",
           "cell_reduce_max", "detect_from_score"]

# The 16-pixel Bresenham circle of radius 3 as (dx, dy), clockwise from
# 12 o'clock (the standard FAST-9/16 ring).
RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous arc length for FAST-9
_CPU_BAND = 16


def fast_score_reference(padded: torch.Tensor,
                         pad: int = EDGE_THRESHOLD) -> torch.Tensor:
    """Exact FAST-9 score of every interior pixel of ``padded [H+2p, W+2p]``:
    max(bright, dark), each the max over the 16 cyclic 9-arcs of the per-arc
    min of (ring - centre), resp. its negation. Returns [H, W] float32."""
    h = padded.shape[0] - 2 * pad
    w = padded.shape[1] - 2 * pad
    # on one CPU thread, bands of 16 rows keep the [16, rows, W] ring in
    # cache (5-10x faster); with a thread pool the bands' many small ops
    # would wait on it, and on the card one pass is best. Each pixel's
    # arithmetic is the same either way
    one_thread = padded.device.type == "cpu" and torch.get_num_threads() == 1
    rows = _CPU_BAND if one_thread else max(h, 1)
    out = padded.new_empty((h, w))
    for r0 in range(0, h, rows):
        r1 = min(r0 + rows, h)
        c = padded[pad + r0: pad + r1, pad: pad + w]
        ring = torch.stack([padded[pad + dy + r0: pad + dy + r1, pad + dx: pad + dx + w]
                            for (dx, dy) in RING_OFFSETS])
        diff_b = ring - c[None]
        out[r0:r1] = torch.maximum(_max_windowed_min(diff_b), _max_windowed_min(-diff_b))
    return out


def _max_windowed_min(d: torch.Tensor) -> torch.Tensor:
    """Max over the 16 cyclic 9-windows of the per-window min of d [16, H, W];
    the window minima by doubling (min is exact in any order)."""
    d24 = torch.cat([d, d[: _ARC - 1]], dim=0)
    m2 = torch.minimum(d24[:-1], d24[1:])    # windows of 2 at 0..22
    m4 = torch.minimum(m2[:-2], m2[2:])      # of 4 at 0..20
    m8 = torch.minimum(m4[:-4], m4[4:])      # of 8 at 0..16
    return torch.minimum(m8[:16], d24[8:24]).amax(dim=0)


def fast_score(padded: torch.Tensor, pad: int = EDGE_THRESHOLD) -> torch.Tensor:
    """FAST-9 score [H, W] of a padded image [H + 2p, W + 2p] float32.

    A CPU tensor runs the plain version; a CUDA tensor launches the kernel.
    """
    if padded.device.type == "cpu":
        return fast_score_reference(padded, pad)
    kernels.require_cuda("fast_score", padded, torch.float32, 2)
    hp, wp = padded.shape
    if pad < 3 or hp - 2 * pad <= 0 or wp - 2 * pad <= 0:
        raise ValueError(f"fast_score: pad {pad} must be >= 3 and leave an "
                         f"interior in {tuple(padded.shape)}")
    out = torch.empty((hp - 2 * pad, wp - 2 * pad), dtype=torch.float32,
                      device=padded.device)
    with torch.cuda.device(padded.device):
        rc = kernels.library().osltt_fast_score(
            padded.data_ptr(), out.data_ptr(), hp, wp, pad,
            torch.cuda.current_stream(padded.device).cuda_stream)
    kernels.check_launch("fast_score", rc)
    fast_score.launches += 1
    return out


fast_score.launches = 0


def cell_reduce_max(x: torch.Tensor, cs: int) -> torch.Tensor:
    """Per-cell max over non-overlapping cs x cs cells, broadcast back to
    pixel resolution. x: [H, W] -> [H, W]."""
    h, w = x.shape
    ph, pw = (-h) % cs, (-w) % cs
    xp = F.pad(x, (0, pw, 0, ph), value=float("-inf"))
    ncy, ncx = (h + ph) // cs, (w + pw) // cs
    cells = xp.reshape(ncy, cs, ncx, cs).amax(dim=(1, 3))
    # expand, not repeat_interleave: the latter may sync to size its output
    back = cells[:, None, :, None].expand(ncy, cs, ncx, cs)
    return back.reshape(ncy * cs, ncx * cs)[:h, :w]


def detect_from_score(score: torch.Tensor, ini_th: int, min_th: int, cell_size: int,
                      pad: int = EDGE_THRESHOLD) -> torch.Tensor:
    """A level's FAST score [h, w] -> the detection score map: zero outside
    the region where keypoints may live ([pad - 3, dim - pad + 3), the
    reference's min/maxBorder), above ``ini_th`` or, in a ``cell_size`` cell
    with no corner above it, above ``min_th`` (``ORBextractor.cpp:1109-1123``),
    and a 3x3 local maximum."""
    h, w = score.shape
    b = pad - 3
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
