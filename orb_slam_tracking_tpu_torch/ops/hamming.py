"""Hamming distance of packed descriptors (counterpart of ``ops/hamming.py``).

Two wrappers of the CUDA kernel ``csrc/hamming_matrix.cu`` (which replaces
the TPU kernel ``hamming_matrix_pallas``):

* ``hamming_matrix``: the all-pairs ``[P, N]`` int32 distance matrix;
* ``hamming_gated_min``: per row of ``[P, 8]`` the least distance over the
  eligible columns of ``[N, 8]``, its column and the second least, under the
  coordinate window and octave gates both matchers use, without the
  ``[P, N]`` matrix.

On CPU tensors each runs its plain version (``hamming_matrix_reference``,
``hamming_gated_min_reference``). PyTorch has no popcount, so the plain
distance takes the descriptors' bit planes through a float32 matrix
product; ``popcount`` sums the bits of int32 words by masked shifts (SWAR).
``.launches`` on each wrapper counts its kernel's launches.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .. import kernels

__all__ = ["BIG", "hamming_matrix", "hamming_matrix_reference", "hamming_gated_min",
           "hamming_gated_min_reference", "popcount"]

BIG = 1 << 20  # the distance of a row with nothing eligible


def hamming_matrix_reference(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[P, 8] x [N, 8] int32 -> [P, N] int32 distances in [0, 256]:
    pop(a) + pop(b) - 2 <a, b> over the descriptors' {0, 1} bit planes,
    the inner products a float32 matrix product (TF32 is off in the port,
    and every partial sum is an integer <= 256, so exact in any order)."""
    a, b = _bit_planes(d1), _bit_planes(d2)
    inner = a @ b.T
    return (a.sum(1)[:, None] + b.sum(1)[None, :] - 2.0 * inner).to(torch.int32)


def _bit_planes(d: torch.Tensor) -> torch.Tensor:
    """[N, 8] int32 words -> [N, 256] float32 bits (masked after the shift,
    since int32 ``>>`` is arithmetic)."""
    shifts = torch.arange(32, dtype=torch.int32, device=d.device)
    return ((d[:, :, None] >> shifts) & 1).reshape(d.shape[0], 256).to(torch.float32)


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each int32 word, by the SWAR bit sums; every shift is
    masked, since int32 ``>>`` is arithmetic."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    return (x + (x >> 16)) & 0x3F


def _check_descriptors(name: str, d1: torch.Tensor, d2: torch.Tensor) -> None:
    kernels.require_cuda(name, d1, torch.int32, 2)
    kernels.require_cuda(name, d2, torch.int32, 2)
    if d1.device != d2.device:
        raise ValueError(f"{name}: tensors on different devices")
    if d1.shape[1] != 8 or d2.shape[1] != 8:
        raise ValueError(f"{name}: expected [*, 8] words, got "
                         f"{tuple(d1.shape)} and {tuple(d2.shape)}")
    if d2.data_ptr() % 16:
        raise ValueError(f"{name}: the column descriptors must be 16-byte aligned")
    if d2.shape[0] >= 1 << 21:
        raise ValueError(f"{name}: {d2.shape[0]} columns exceed the kernel's 2^21")


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance, [P, 8] x [N, 8] int32 -> [P, N] int32.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_matrix_reference(d1, d2)
    _check_descriptors("hamming_matrix", d1, d2)
    p, n = d1.shape[0], d2.shape[0]
    out = torch.empty((p, n), dtype=torch.int32, device=d1.device)
    if p == 0 or n == 0:
        return out
    with torch.cuda.device(d1.device):
        rc = kernels.library().osltt_hamming_matrix(
            d1.data_ptr(), d2.data_ptr(), out.data_ptr(), p, n,
            torch.cuda.current_stream(d1.device).cuda_stream)
    kernels.check_launch("hamming_matrix", rc)
    hamming_matrix.launches += 1
    return out


hamming_matrix.launches = 0


def hamming_gated_min_reference(
    d1: torch.Tensor, d2: torch.Tensor,
    row_uv: torch.Tensor, row_r: torch.Tensor, row_use: torch.Tensor,
    row_lo: torch.Tensor, row_hi: torch.Tensor, row_ok: torch.Tensor,
    col_xy: torch.Tensor, col_r: torch.Tensor, col_oct: torch.Tensor,
    col_ok: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gated row minima through the dense [P, N] matrix.

    Pair (i, j) is eligible when ``row_ok[i] & col_ok[j] & |u_i - x_j| <= r
    & |v_i - y_j| <= r & row_lo[i] <= col_oct[j] <= row_hi[i]``, with
    ``r = row_r[i] if row_use[i] else col_r[j]``. Returns ``best`` (``BIG``
    where nothing is eligible), ``best_j`` (the lowest column on ties, 0
    where nothing is eligible, as ``argmin`` of a constant row) and
    ``second`` (the least over the columns other than ``best_j``), all [P]
    int32."""
    D = hamming_matrix_reference(d1, d2)
    dx = (row_uv[:, 0:1] - col_xy[None, :, 0]).abs()
    dy = (row_uv[:, 1:2] - col_xy[None, :, 1]).abs()
    r = torch.where(row_use[:, None], row_r[:, None], col_r[None, :])
    oct_ = col_oct[None, :]
    eligible = (row_ok[:, None] & col_ok[None, :] & (dx <= r) & (dy <= r)
                & (oct_ >= row_lo[:, None]) & (oct_ <= row_hi[:, None]))
    Dm = torch.where(eligible, D, BIG)
    best, best_j = Dm.min(dim=1)  # first index on ties, as jnp.argmin
    cols = torch.arange(d2.shape[0], device=d1.device)
    second = torch.where(cols[None, :] == best_j[:, None], BIG, Dm).amin(dim=1)
    return best, best_j.to(torch.int32), second


def hamming_gated_min(
    d1: torch.Tensor, d2: torch.Tensor,
    row_uv: torch.Tensor, row_r: torch.Tensor, row_use: torch.Tensor,
    row_lo: torch.Tensor, row_hi: torch.Tensor, row_ok: torch.Tensor,
    col_xy: torch.Tensor, col_r: torch.Tensor, col_oct: torch.Tensor,
    col_ok: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per row of ``d1 [P, 8]``: (best, best_j, second) [P] int32 over the
    eligible columns of ``d2 [N, 8]`` (see ``hamming_gated_min_reference``).

    Rows: ``row_uv [P, 2]`` and ``row_r`` f32, ``row_use`` and ``row_ok``
    bool, ``row_lo``/``row_hi`` int32; columns: ``col_xy [N, 2]`` and
    ``col_r`` f32, ``col_oct`` int32, ``col_ok`` bool. CPU tensors run the
    plain version; CUDA tensors launch the kernel, which never forms the
    [P, N] matrix.
    """
    args = (row_uv, row_r, row_use, row_lo, row_hi, row_ok, col_xy, col_r, col_oct, col_ok)
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_gated_min_reference(d1, d2, *args)
    name = "hamming_gated_min"
    _check_descriptors(name, d1, d2)
    p, n = d1.shape[0], d2.shape[0]
    if n == 0:
        raise ValueError(f"{name}: no columns to take a minimum over")
    specs = ((row_uv, torch.float32, (p, 2)), (row_r, torch.float32, (p,)),
             (row_use, torch.bool, (p,)), (row_lo, torch.int32, (p,)),
             (row_hi, torch.int32, (p,)), (row_ok, torch.bool, (p,)),
             (col_xy, torch.float32, (n, 2)), (col_r, torch.float32, (n,)),
             (col_oct, torch.int32, (n,)), (col_ok, torch.bool, (n,)))
    for t, dtype, shape in specs:
        kernels.require_cuda(name, t, dtype, len(shape))
        if tuple(t.shape) != shape or t.device != d1.device:
            raise ValueError(f"{name}: expected shape {shape} on {d1.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    best, best_j, second = torch.empty((3, p), dtype=torch.int32, device=d1.device)
    if p == 0:
        return best, best_j, second
    with torch.cuda.device(d1.device):
        rc = kernels.library().osltt_hamming_gated_min(
            d1.data_ptr(), d2.data_ptr(), p, n, *(t.data_ptr() for t in args),
            best.data_ptr(), best_j.data_ptr(), second.data_ptr(),
            torch.cuda.current_stream(d1.device).cuda_stream)
    kernels.check_launch(name, rc)
    hamming_gated_min.launches += 1
    return best, best_j, second


hamming_gated_min.launches = 0
