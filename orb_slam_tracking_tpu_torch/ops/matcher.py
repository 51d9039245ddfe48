"""Two-frame initialization matching (counterpart of ``ops/matcher.py``,
ORB-SLAM's ``SearchForInitialization``).

Best and second best per frame-1 keypoint inside a coordinate window (in
place of the grid lookup) come from the ``hamming_gated_min`` kernel
wrapper, which never forms the [N1, N2] Hamming matrix; then the ratio
test, a mutual resolution (per frame-2 keypoint the closest claimant
wins, the lower frame-1 index breaking ties) in place of the reference's
in-order stealing, and the 30-bin rotation histogram keeping the top
three bins with the 0.1x gates of ``ComputeThreeMaxima``.

``jax.lax.top_k`` puts the lower bin first on ties; here a stable
descending sort gives the same order. ``.at[].min`` becomes
``scatter_reduce_("amin")``; the histogram's ``.at[].add`` becomes
``index_add_``, with a spare bin for out-of-range indices, which the JAX
scatter drops.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MatcherConfig
from .hamming import BIG, hamming_gated_min

__all__ = ["MatchResult", "search_for_initialization", "compact_matches"]

_SENTINEL = torch.iinfo(torch.int32).max


class MatchResult(NamedTuple):
    matches12: torch.Tensor  # [N1] int32 index into frame-2 keypoints, -1 = none
    distances: torch.Tensor  # [N1] int32 Hamming distance (where matched)
    n_matches: torch.Tensor  # [] int32
    n_reject_distance: torch.Tensor     # [] int32
    n_reject_ratio: torch.Tensor        # [] int32
    n_reject_orientation: torch.Tensor  # [] int32


def search_for_initialization(
    desc1: torch.Tensor, xy1: torch.Tensor, octave1: torch.Tensor,
    angle1: torch.Tensor, valid1: torch.Tensor,
    desc2: torch.Tensor, xy2: torch.Tensor, octave2: torch.Tensor,
    angle2: torch.Tensor, valid2: torch.Tensor,
    cfg: MatcherConfig,
) -> MatchResult:
    """Match frame-1 keypoints to frame-2 keypoints for initialization.

    Coordinates are undistorted level-0 pixels; only octave-0 keypoints
    take part on both sides (``ORBmatcher.cpp:36-44``)."""
    n1, n2 = desc1.shape[0], desc2.shape[0]
    dev = desc1.device

    # only octave-0 keypoints of both frames, inside the window on both
    # axes. The gates fold into what exists: a frame-1 row takes part only
    # at octave 0 and then admits frame-2 octaves in [octave1, octave1], so
    # 0 alone; rows that take part use the window as their radius (one
    # constant vector, sliced for the unused column radius)
    oct1, oct2 = octave1.to(torch.int32), octave2.to(torch.int32)
    row_ok = valid1 & (oct1 == 0)
    window = torch.full((max(n1, n2),), cfg.window_size, dtype=torch.float32, device=dev)
    best, best_j, second = hamming_gated_min(
        desc1, desc2, xy1, window[:n1], row_ok, oct1, oct1, row_ok,
        xy2, window[:n2], oct2, valid2)

    had_candidate = best < BIG
    pass_low = best <= cfg.th_low
    pass_ratio = best.float() < cfg.nn_ratio * second.float()
    accept = had_candidate & pass_low & pass_ratio

    # mutual resolution: per frame-2 index keep the single closest claimant
    # (distance-then-index key)
    rows = torch.arange(n1, dtype=torch.int32, device=dev)
    key = torch.where(accept, torch.where(accept, best, 0) * n1 + rows, _SENTINEL)
    min_key = torch.full((n2,), _SENTINEL, dtype=torch.int32, device=dev)
    j = best_j.to(torch.int64)
    min_key.scatter_reduce_(0, j, key, "amin")
    keep = accept & (key == min_key[j])

    n_reject_distance = (had_candidate & ~pass_low).sum(dtype=torch.int32)
    n_reject_ratio = (had_candidate & pass_low & ~pass_ratio).sum(dtype=torch.int32)

    if cfg.check_orientation:
        L = cfg.histo_length
        rot = angle1 - angle2[j]
        rot = torch.where(rot < 0, rot + 360.0, rot)
        b = torch.round(rot * (L / 360.0)).to(torch.int32)
        b = torch.where(b == L, 0, b)
        slot = torch.where((b >= 0) & (b < L), b, L).to(torch.int64)
        counts = torch.zeros(L + 1, dtype=torch.int32, device=dev)
        counts.index_add_(0, slot, keep.to(torch.int32))
        top_counts, top_bins = torch.sort(counts[:L], descending=True, stable=True)
        c1, c2, c3 = top_counts[0].float(), top_counts[1].float(), top_counts[2].float()
        allow2 = c2 >= 0.1 * c1
        allow3 = c3 >= 0.1 * c1
        in_top = ((b == top_bins[0]) | ((b == top_bins[1]) & allow2)
                  | ((b == top_bins[2]) & allow3))
        n_reject_orientation = (keep & ~in_top).sum(dtype=torch.int32)
        keep = keep & in_top
    else:
        n_reject_orientation = torch.zeros((), dtype=torch.int32, device=dev)

    return MatchResult(
        matches12=torch.where(keep, best_j, -1),
        distances=torch.where(keep, best, BIG),
        n_matches=keep.sum(dtype=torch.int32),
        n_reject_distance=n_reject_distance,
        n_reject_ratio=n_reject_ratio,
        n_reject_orientation=n_reject_orientation,
    )


def compact_matches(matches12: torch.Tensor, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse matches [N1] -> (pairs [min(cap, N1), 2] int32 (i1, i2),
    valid [min(cap, N1)] bool): matched rows first, in index order, like the
    reference's ``mvMatches12`` compaction (``Initializer.cpp:24-34``)."""
    matched = matches12 >= 0
    order = torch.argsort((~matched).to(torch.int32), stable=True)
    take = order[:cap]
    valid = matched[take]
    i1 = torch.where(valid, take.to(torch.int32), 0)
    i2 = torch.where(valid, matches12[take], 0)
    return torch.stack([i1, i2], dim=-1), valid
