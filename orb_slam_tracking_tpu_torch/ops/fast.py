"""FAST-9/16 corner score (counterpart of ``ops/fast.py``).

``fast_score`` is the wrapper of the CUDA kernel ``csrc/fast_score.cu``
(which replaces the TPU kernel ``fast_score_pallas``); on a CPU tensor it
runs ``fast_score_reference``, the plain PyTorch version of the same
function. ``fast_score.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import kernels
from .pattern import EDGE_THRESHOLD

__all__ = ["RING_OFFSETS", "fast_score", "fast_score_reference",
           "cell_reduce_max"]

# The 16-pixel Bresenham circle of radius 3 as (dx, dy), clockwise from
# 12 o'clock (the standard FAST-9/16 ring).
RING_OFFSETS = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)
_ARC = 9  # contiguous arc length for FAST-9


def fast_score_reference(padded: torch.Tensor,
                         pad: int = EDGE_THRESHOLD) -> torch.Tensor:
    """Exact FAST-9 score of every interior pixel of ``padded [H+2p, W+2p]``:
    max(bright, dark), each the max over the 16 cyclic 9-arcs of the per-arc
    min of (ring - centre), resp. its negation. Returns [H, W] float32."""
    h = padded.shape[0] - 2 * pad
    w = padded.shape[1] - 2 * pad
    c = padded[pad: pad + h, pad: pad + w]
    ring = torch.stack([padded[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                        for (dx, dy) in RING_OFFSETS])
    diff_b = ring - c[None]
    diff_d = -diff_b
    return torch.maximum(_max_windowed_min(diff_b), _max_windowed_min(diff_d))


def _max_windowed_min(d: torch.Tensor) -> torch.Tensor:
    d24 = torch.cat([d, d[: _ARC - 1]], dim=0)
    acc = d24[0:16]
    for k in range(1, _ARC):
        acc = torch.minimum(acc, d24[k: k + 16])
    return acc.amax(dim=0)


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
