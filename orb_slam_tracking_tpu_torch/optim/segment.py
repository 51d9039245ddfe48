"""Segment sums that give the same bits on every run (the JAX package's
``.at[idx].add`` over a fixed index set).

``index_add_`` on a CUDA tensor accumulates floats with atomics, so the
order of the additions, and the last bits of the sums, change from run to
run. Here the index set is sorted once (``segments``: a stable argsort and
the segment offsets, built on the device without a host read) and every
later sum over it gathers the values in that order and reduces each
segment with ``torch.segment_reduce``, which adds a segment's values one
after another in a fixed order: the same result on every run, and on the
CPU the same additions, in the same order, as ``index_add_``.

A segment is summed by one thread, so a long segment is slow. Entries
that add nothing (an invalid observation's zero-weight terms, which a
fixed-capacity list holds by the thousand, all on slot 0) are left out:
``valid`` sorts them past the last segment, where no sum reads them.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

__all__ = ["Segments", "segments", "segment_sum"]


class Segments(NamedTuple):
    order: torch.Tensor    # [O] int64: the values' order, sorted by segment (stable)
    offsets: torch.Tensor  # [n + 1] int64: segment s is order[offsets[s]:offsets[s + 1]]


def segments(idx: torch.Tensor, n: int, valid: Optional[torch.Tensor] = None) -> Segments:
    """The segments of ``idx [O]`` (values in [0, n)) for ``segment_sum``;
    entries where ``valid [O]`` is False are in no segment."""
    key = idx.long() if valid is None else torch.where(valid, idx.long(), n)
    order = torch.argsort(key, stable=True)
    bounds = torch.arange(n + 1, dtype=torch.int64, device=idx.device)
    return Segments(order, torch.searchsorted(key[order], bounds))


def segment_sum(vals: torch.Tensor, seg: Segments) -> torch.Tensor:
    """``vals [O, ...]`` summed into ``[n, ...]`` rows by the segments
    ``seg`` of their index set; an empty segment sums to 0. ``unsafe``
    skips the offsets' validation, which would read them on the host (the
    offsets end before the left-out entries)."""
    return torch.segment_reduce(vals[seg.order], "sum", offsets=seg.offsets, axis=0,
                                unsafe=True)
