"""Per-cell top-1 keypoint selection with a fixed per-level budget.

Counterpart of ``orb_slam_tracking_tpu/ops/select.py``: per-cell argmax of
the masked score map, then the ``budget`` best cells. ``jax.lax.top_k``
puts the lower index first on ties, which integer-valued images make
common; ``torch.topk`` promises no order, so this takes a stable
descending sort and keeps its first ``budget`` entries.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

__all__ = ["select_level"]


def select_level(score: torch.Tensor, budget: int, cell_size: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """score [H, W] float32 (zero where ineligible) -> (xy [budget, 2]
    float32 level coords, response [budget] float32, valid [budget] bool)."""
    h, w = score.shape
    cs = cell_size
    ph, pw = (-h) % cs, (-w) % cs
    ncy, ncx = (h + ph) // cs, (w + pw) // cs
    n_cells = ncy * ncx
    if n_cells < budget:
        raise ValueError(
            f"selection grid {ncy}x{ncx} has fewer cells than budget {budget}; "
            f"decrease cell_size ({cs}) or budget")
    sp = F.pad(score, (0, pw, 0, ph))
    cells = (sp.reshape(ncy, cs, ncx, cs).permute(0, 2, 1, 3)
             .reshape(n_cells, cs * cs))
    cell_best, cell_arg = cells.max(dim=1)  # first index on ties, as argmax
    order = torch.sort(cell_best, descending=True, stable=True).indices
    top_cell = order[:budget]
    top_resp = cell_best[top_cell]
    flat = cell_arg[top_cell]
    y = (top_cell // ncx) * cs + flat // cs
    x = (top_cell % ncx) * cs + flat % cs
    xy = torch.stack([x, y], dim=-1).to(torch.float32)
    return xy, top_resp, top_resp > 0.0
