"""Tensor-parallel descriptor matching: the map table sharded over the
ranks of a process group (counterpart of ``parallel/matcher_sharded.py``).

Each rank holds a contiguous slice of the map descriptor table and takes
its rows' best, best column and second best per query from the fused
Hamming kernel with every gate open (``ops.matcher.open_gated_min``, B3f),
which never forms the ``[N, P/D]`` distance block that the JAX module
builds. The only communication is the per-query top-2 merge: two
``[N]`` all-gathers of the merge keys and second bests, and one
all-gather of the ``[P/D]`` mutual-check keys.

Semantics are those of ``ops.matcher.match_descriptors`` and of the JAX
function exactly: best + ratio + threshold + order-independent mutual
resolution, ties to the lowest *global* map index through lexicographic
(distance, index) merge keys. A map row's best query never leaves its
shard: each rank owns its rows, so its column minimum over the replicated
queries is already global.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops import matcher
from .distributed import all_gather, group_rank_size

__all__ = ["match_descriptors_tp"]

# the JAX module's masked-distance sentinel: its merge keys are dist * P +
# idx in int32, so (BIG + 1) * P stays under 2^31. The fused kernel writes
# 1 << 20 where a row has nothing eligible; it is clamped to this, which
# changes no decision (th < ratio * BIG) and keeps the keys JAX's
_BIG = 1 << 15
_SENTINEL = torch.iinfo(torch.int32).max


def match_descriptors_tp(desc_q: torch.Tensor, valid_q: torch.Tensor, desc_m: torch.Tensor,
                         valid_m: torch.Tensor, ratio: float = 0.75, th: int = 50,
                         group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Sharded ``match_descriptors``: the queries ``desc_q [N, 8]`` int32
    and ``valid_q [N]`` are replicated; ``desc_m [P/D, 8]`` and ``valid_m
    [P/D]`` are this rank's contiguous slice of the ``[P, 8]`` map table
    (rank r holds rows ``r * P/D`` up to ``(r + 1) * P/D``; see
    ``distributed.make_global_array``). ``group``: the ranks the map is
    sharded over (None = the default group). Returns matches [N] int32
    into the whole table (-1 none), the same on every rank.

    The whole table may hold at most 65,532 rows: JAX's int32 key bound,
    kept as the function's contract."""
    rank, size = group_rank_size(group, desc_q.device)
    n, per = desc_q.shape[0], desc_m.shape[0]
    p_total = per * size
    if p_total > (1 << 31) // (_BIG + 2):
        raise ValueError(f"a {p_total}-row map would overflow the int32 merge keys")
    best, best_j, second = matcher.open_gated_min(desc_q, valid_q, desc_m, valid_m)
    best, second = best.clamp_max(_BIG), second.clamp_max(_BIG)
    gbase = rank * per
    key_best = best * p_total + gbase + best_j
    # the per-query top-2 merge across ranks ([N]-sized collectives)
    all_best = all_gather(key_best, group, size)             # [D, N]
    all_second = all_gather(second, group, size)             # [D, N]
    gkey, win = all_best.min(dim=0)
    # global second best: every rank's second and every other rank's best
    best_d = all_best // p_total
    ranks = torch.arange(size, device=desc_q.device)[:, None]
    second2 = torch.where(ranks == win[None, :], all_second,
                          torch.minimum(all_second, best_d)).amin(dim=0)
    gbest, gbest_j = gkey // p_total, gkey % p_total
    accept = (gbest <= th) & (gbest.float() < ratio * second2.float()) & valid_q
    # order-independent mutual resolution: each map row keeps its best
    # query, by a scatter-min over this rank's rows, then shared
    qrows = torch.arange(n, dtype=torch.int32, device=desc_q.device)
    qkey = torch.where(accept, gbest * n + qrows, _SENTINEL)
    local_j = gbest_j - gbase
    in_shard = (local_j >= 0) & (local_j < per)
    min_key_local = torch.full((per,), _SENTINEL, dtype=torch.int32, device=desc_q.device)
    min_key_local.scatter_reduce_(0, torch.where(in_shard, local_j, 0).long(),
                                  torch.where(in_shard, qkey, _SENTINEL), "amin")
    min_key = all_gather(min_key_local, group, size).reshape(p_total)
    keep = accept & (qkey == min_key[gbest_j.long()])
    return torch.where(keep, gbest_j, -1)
