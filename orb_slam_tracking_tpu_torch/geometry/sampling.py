"""RANSAC minimal-set sampling without replacement (counterpart of
``geometry/sampling.py``).

The reduced-range construction, vectorised over hypotheses: the j-th draw
is uniform over the ``n - j`` slots not yet taken and is shifted past the
earlier (sorted) choices, which gives exactly uniform distinct k-subsets.
The uniforms are an argument: the JAX package draws them with
``jax.random.uniform(key, (iters, k))``, which a ``torch.Generator``
cannot reproduce, so the tests hand JAX's draws to both.
"""

from __future__ import annotations

import torch

__all__ = ["sample_distinct"]


def sample_distinct(u: torch.Tensor, n_valid: torch.Tensor, k: int) -> torch.Tensor:
    """[iters, k] distinct int32 indices uniform over [0, n_valid) per row,
    from uniforms ``u`` [iters, k] in [0, 1) and a 0-d count ``n_valid``.

    When ``n_valid < k`` (degenerate; callers gate on far larger counts)
    indices are clipped into range and need not be distinct."""
    iters = u.shape[0]
    n = torch.clamp(n_valid, min=k).to(torch.float32)
    chosen = torch.zeros((iters, k), dtype=torch.int32, device=u.device)
    for j in range(k):
        d = torch.floor(u[:, j] * (n - j)).to(torch.int32)
        d = torch.minimum(d, (n - j).to(torch.int32) - 1)
        prev = torch.sort(chosen[:, :j], dim=1).values
        for i in range(j):
            d = d + (d >= prev[:, i]).to(torch.int32)
        chosen[:, j] = d
    hi = torch.clamp(n_valid - 1, min=0).to(torch.int32)
    return torch.minimum(chosen.clamp_min(0), hi)
