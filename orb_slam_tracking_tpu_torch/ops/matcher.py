"""Descriptor matchers (counterpart of ``ops/matcher.py``).

``search_for_initialization`` (ORB-SLAM's ``SearchForInitialization``):

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

``search_for_triangulation`` (``SearchForTriangulation``): unassociated
keypoints of two keyframes, gated by the epipolar line instead of a
window. Its pairs come from the all-pairs ``hamming_matrix`` kernel, one
launch for every covisible neighbour of a keyframe insert (their rows
stacked), then the per-pair epipolar gate, the ratio test, the mutual
resolution and the rotation histogram of the initialization matcher.

``match_descriptors`` (the ``SearchByBoW`` role without a vocabulary):
window-free best + ratio + mutual, through ``hamming_gated_min`` with
every gate open (``open_gated_min``, which the tensor-parallel matcher,
``parallel/matcher_sharded.py``, takes per map shard).

``match_descriptors_bow`` (``SearchByBoW`` itself): the same, but a pair
is compared only under the same vocabulary direct-index node. Its pairs
come from the all-pairs ``hamming_matrix`` kernel and the node gate is
applied to the matrix, as the JAX package does.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..config import MatcherConfig
from .hamming import BIG, hamming_gated_min, hamming_matrix

__all__ = ["MatchResult", "search_for_initialization", "search_for_triangulation",
           "match_descriptors", "match_descriptors_bow", "open_gated_min",
           "compact_matches"]

_SENTINEL = torch.iinfo(torch.int32).max
_INT_MIN = torch.iinfo(torch.int32).min


class MatchResult(NamedTuple):
    matches12: torch.Tensor  # [N1] int32 index into frame-2 keypoints, -1 = none
    distances: torch.Tensor  # [N1] int32 Hamming distance (where matched)
    n_matches: torch.Tensor  # [] int32
    n_reject_distance: torch.Tensor     # [] int32
    n_reject_ratio: torch.Tensor        # [] int32
    n_reject_orientation: torch.Tensor  # [] int32


def _rotation_consistent(keep: torch.Tensor, rot: torch.Tensor, L: int) -> torch.Tensor:
    """The rotation-histogram check over the last axis: ``keep`` [..., N1]
    bool, ``rot`` [..., N1] the angle differences (deg) of each row's match.
    Each batch row bins its kept matches' rotations into ``L`` bins and
    keeps the top three (the lower bin first on equal counts, as
    ``lax.top_k``; ``ComputeThreeMaxima``'s 0.1x gates on the second and
    third). -> [..., N1] bool: the row's bin is one of those kept."""
    rot = torch.where(rot < 0, rot + 360.0, rot)
    b = torch.round(rot * (L / 360.0)).to(torch.int32)
    b = torch.where(b == L, 0, b)
    # out-of-range bins go to a spare bin L, which the JAX scatter drops
    slot = torch.where((b >= 0) & (b < L), b, L).to(torch.int64)
    counts = torch.zeros(keep.shape[:-1] + (L + 1,), dtype=torch.int32, device=keep.device)
    counts.scatter_add_(-1, slot, keep.to(torch.int32))
    top_counts, top_bins = torch.sort(counts[..., :L], dim=-1, descending=True, stable=True)
    c = top_counts[..., :3].float()
    allow2 = (c[..., 1] >= 0.1 * c[..., 0])[..., None]
    allow3 = (c[..., 2] >= 0.1 * c[..., 0])[..., None]
    return ((b == top_bins[..., 0:1]) | ((b == top_bins[..., 1:2]) & allow2)
            | ((b == top_bins[..., 2:3]) & allow3))


def _mutual(accept: torch.Tensor, best: torch.Tensor, best_j: torch.Tensor,
            n2: int) -> torch.Tensor:
    """Mutual resolution over the last axis of ``accept`` [..., N1]: per
    frame-2 index ``best_j`` keep the single closest claimant of each batch
    row, the lower frame-1 index breaking ties (a distance-then-index key,
    ``scatter_reduce_("amin")`` for the ``.at[].min``)."""
    n1 = accept.shape[-1]
    rows = torch.arange(n1, dtype=torch.int32, device=accept.device)
    key = torch.where(accept, torch.where(accept, best, 0) * n1 + rows, _SENTINEL)
    min_key = torch.full(accept.shape[:-1] + (n2,), _SENTINEL, dtype=torch.int32,
                         device=accept.device)
    j = best_j.to(torch.int64)
    min_key.scatter_reduce_(-1, j, key, "amin")
    return accept & (key == min_key.gather(-1, j))


def search_for_initialization(
    desc1: torch.Tensor, xy1: torch.Tensor, octave1: torch.Tensor,
    angle1: torch.Tensor, valid1: torch.Tensor,
    desc2: torch.Tensor, xy2: torch.Tensor, octave2: torch.Tensor,
    angle2: torch.Tensor, valid2: torch.Tensor,
    cfg: MatcherConfig,
) -> MatchResult:
    """Match frame-1 keypoints to frame-2 keypoints for initialization.

    Coordinates are undistorted level-0 pixels; only octave-0 keypoints
    take part on both sides (``ORBmatcher.cpp:36-44``). A leading [B] on
    every argument matches B pairs at once (one Hamming-kernel launch), and
    every output then has it."""
    lead, n1, n2 = desc1.shape[:-2], desc1.shape[-2], desc2.shape[-2]
    dev = desc1.device

    # only octave-0 keypoints of both frames, inside the window on both
    # axes. The gates fold into what exists: a frame-1 row takes part only
    # at octave 0 and then admits frame-2 octaves in [octave1, octave1], so
    # 0 alone; rows that take part use the window as their radius (one
    # constant per row and per column)
    oct1, oct2 = octave1.to(torch.int32), octave2.to(torch.int32)
    row_ok = valid1 & (oct1 == 0)
    r1, r2 = (torch.full(lead + (n,), cfg.window_size, dtype=torch.float32, device=dev)
              for n in (n1, n2))
    best, best_j, second = hamming_gated_min(
        desc1, desc2, xy1, r1, row_ok, oct1, oct1, row_ok, xy2, r2, oct2, valid2)

    had_candidate = best < BIG
    pass_low = best <= cfg.th_low
    pass_ratio = best.float() < cfg.nn_ratio * second.float()
    accept = had_candidate & pass_low & pass_ratio

    keep = _mutual(accept, best, best_j, n2)

    n_reject_distance = (had_candidate & ~pass_low).sum(dim=-1, dtype=torch.int32)
    n_reject_ratio = (had_candidate & pass_low & ~pass_ratio).sum(dim=-1, dtype=torch.int32)

    if cfg.check_orientation:
        rot = angle1 - angle2.gather(-1, best_j.to(torch.int64))
        in_top = _rotation_consistent(keep, rot, cfg.histo_length)
        n_reject_orientation = (keep & ~in_top).sum(dim=-1, dtype=torch.int32)
        keep = keep & in_top
    else:
        n_reject_orientation = torch.zeros(lead, dtype=torch.int32, device=dev)

    return MatchResult(
        matches12=torch.where(keep, best_j, -1),
        distances=torch.where(keep, best, BIG),
        n_matches=keep.sum(dim=-1, dtype=torch.int32),
        n_reject_distance=n_reject_distance,
        n_reject_ratio=n_reject_ratio,
        n_reject_orientation=n_reject_orientation,
    )


def search_for_triangulation(
    desc1: torch.Tensor, xy1: torch.Tensor, octave1: torch.Tensor,
    angle1: torch.Tensor, valid1: torch.Tensor,
    desc2: torch.Tensor, xy2: torch.Tensor, octave2: torch.Tensor,
    angle2: torch.Tensor, valid2: torch.Tensor,
    F21: torch.Tensor, cfg: MatcherConfig, scale_factor: float = 1.2,
) -> MatchResult:
    """Epipolar-gated matching of two keyframes' unassociated keypoints.

    A pair is eligible when the frame-2 keypoint's squared distance to the
    epipolar line ``F21 @ x1`` is below ``3.84 * scale^(2 octave2)``; there
    is no octave restriction and no window. Frame 1 carries a leading
    batch axis (``desc1 [B, N1, 8]``, ``xy1 [B, N1, 2]``, the others
    ``[B, N1]``, ``F21 [B, 3, 3]``): the B frame-1 keyframes are matched
    against the one frame 2 with one ``hamming_matrix`` launch over their
    stacked rows, and every output has the batch axis."""
    B, n1 = desc1.shape[:2]
    n2 = desc2.shape[0]
    D = hamming_matrix(desc1.reshape(B * n1, 8), desc2).view(B, n1, n2)

    p1 = torch.cat([xy1, torch.ones_like(xy1[..., :1])], dim=-1)   # [B, N1, 3]
    l2 = p1 @ F21.transpose(-1, -2)
    num = (l2[..., 0:1] * xy2[None, None, :, 0] + l2[..., 1:2] * xy2[None, None, :, 1]
           + l2[..., 2:3])
    den = (l2[..., 0:1] ** 2 + l2[..., 1:2] ** 2).clamp_min(1e-12)
    sigma2_2 = scale_factor ** (2.0 * octave2.to(torch.float32))
    on_epiline = num * num / den < 3.84 * sigma2_2
    eligible = valid1[..., None] & valid2[None, None, :] & on_epiline
    Dm = torch.where(eligible, D, BIG)
    best, best_j = Dm.min(dim=-1)  # first index on ties, as jnp.argmin
    cols = torch.arange(n2, device=D.device)
    second = torch.where(cols == best_j[..., None], BIG, Dm).amin(dim=-1)
    best_j = best_j.to(torch.int32)

    had_candidate = best < BIG
    pass_low = best <= cfg.th_low
    pass_ratio = best.float() < cfg.nn_ratio * second.float()
    accept = had_candidate & pass_low & pass_ratio
    keep = _mutual(accept, best, best_j, n2)
    n_reject_distance = (had_candidate & ~pass_low).sum(dim=-1, dtype=torch.int32)
    n_reject_ratio = (had_candidate & pass_low & ~pass_ratio).sum(dim=-1, dtype=torch.int32)
    if cfg.check_orientation:
        rot = angle1 - angle2[best_j.long()]
        in_top = _rotation_consistent(keep, rot, cfg.histo_length)
        n_reject_orientation = (keep & ~in_top).sum(dim=-1, dtype=torch.int32)
        keep = keep & in_top
    else:
        n_reject_orientation = torch.zeros(B, dtype=torch.int32, device=D.device)
    return MatchResult(
        matches12=torch.where(keep, best_j, -1),
        distances=torch.where(keep, best, BIG),
        n_matches=keep.sum(dim=-1, dtype=torch.int32),
        n_reject_distance=n_reject_distance,
        n_reject_ratio=n_reject_ratio,
        n_reject_orientation=n_reject_orientation,
    )


def match_descriptors(desc1: torch.Tensor, valid1: torch.Tensor,
                      desc2: torch.Tensor, valid2: torch.Tensor,
                      ratio: float = 0.75, th: int = 50) -> torch.Tensor:
    """Window-free global matching: per valid row of ``desc1 [N1, 8]`` the
    closest valid row of ``desc2 [N2, 8]``, kept when its distance is at
    most ``th``, below ``ratio`` x the second least, and the closest
    claimant of that row. -> matches12 [N1] int32 (-1 = none).

    The row minima are ``open_gated_min``'s."""
    best, best_j, second = open_gated_min(desc1, valid1, desc2, valid2)
    accept = (best <= th) & (best.float() < ratio * second.float())
    keep = _mutual(accept, best, best_j, desc2.shape[0])
    return torch.where(keep, best_j, -1)


def open_gated_min(desc1: torch.Tensor, valid1: torch.Tensor, desc2: torch.Tensor,
                   valid2: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(best, best_j, second) [N1] int32 of each row of ``desc1 [N1, 8]``
    over the valid rows of ``desc2 [N2, 8]``: ``hamming_gated_min`` with
    every gate open (all coordinates and radii 0, so every window test
    holds, and the octave range the whole int32 line)."""
    n1, n2 = desc1.shape[0], desc2.shape[0]
    n, dev = max(n1, n2), desc1.device
    xy = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    r = torch.zeros(n, dtype=torch.float32, device=dev)
    octave = torch.zeros(n, dtype=torch.int32, device=dev)
    lo = torch.full((n1,), _INT_MIN, dtype=torch.int32, device=dev)
    hi = torch.full((n1,), _SENTINEL, dtype=torch.int32, device=dev)
    return hamming_gated_min(desc1, desc2, xy[:n1], r[:n1], valid1, lo, hi, valid1,
                             xy[:n2], r[:n2], octave[:n2], valid2)


def match_descriptors_bow(desc1: torch.Tensor, valid1: torch.Tensor, node1: torch.Tensor,
                          desc2: torch.Tensor, valid2: torch.Tensor, node2: torch.Tensor,
                          ratio: float = 0.75, th: int = 50) -> torch.Tensor:
    """``match_descriptors`` with best and second best confined to pairs
    under the same direct-index node (``node1 [N1]``, ``node2 [N2]``, from
    ``bow.vocabulary.direct_index_nodes``): the ratio test inside one
    vocabulary cell. -> matches12 [N1] int32 (-1 = none)."""
    n2 = desc2.shape[0]
    D = hamming_matrix(desc1, desc2)
    elig = valid1[:, None] & valid2[None, :] & (node1[:, None] == node2[None, :])
    Dm = torch.where(elig, D, BIG)
    best, best_j = Dm.min(dim=1)  # first index on ties, as jnp.argmin
    cols = torch.arange(n2, device=D.device)
    second = torch.where(cols == best_j[:, None], BIG, Dm).amin(dim=1)
    best_j = best_j.to(torch.int32)
    accept = (best <= th) & (best.float() < ratio * second.float())
    keep = _mutual(accept, best, best_j, n2)
    return torch.where(keep, best_j, -1)


def compact_matches(matches12: torch.Tensor, cap: int
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sparse matches [(B,) N1] -> (pairs [(B,) min(cap, N1), 2] int32 (i1,
    i2), valid [(B,) min(cap, N1)] bool): matched rows first, in index
    order, like the reference's ``mvMatches12`` compaction
    (``Initializer.cpp:24-34``)."""
    matched = matches12 >= 0
    order = torch.argsort((~matched).to(torch.int32), dim=-1, stable=True)
    take = order[..., :cap]
    valid = matched.gather(-1, take)
    i1 = torch.where(valid, take.to(torch.int32), 0)
    i2 = torch.where(valid, matches12.gather(-1, take), 0)
    return torch.stack([i1, i2], dim=-1), valid
