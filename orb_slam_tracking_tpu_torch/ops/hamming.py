"""All-pairs Hamming distance of packed descriptors (counterpart of
``ops/hamming.py``).

``hamming_matrix`` is the wrapper of the CUDA kernel
``csrc/hamming_matrix.cu`` (which replaces the TPU kernel
``hamming_matrix_pallas``); on CPU tensors it runs
``hamming_matrix_reference``, a plain XOR + popcount. PyTorch has no
popcount and its int32 ``>>`` is arithmetic, so the plain version masks
each shifted bit with ``& 1``. ``hamming_matrix.launches`` counts the
kernel's launches.
"""

from __future__ import annotations

import torch

from .. import kernels

__all__ = ["hamming_matrix", "hamming_matrix_reference"]


def hamming_matrix_reference(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """[P, 8] x [N, 8] int32 -> [P, N] int32 distances in [0, 256]."""
    x = d1[:, None, :] ^ d2[None, :, :]
    count = torch.zeros_like(x)
    for k in range(32):
        count += (x >> k) & 1
    return count.sum(dim=-1, dtype=torch.int32)


def hamming_matrix(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """All-pairs Hamming distance, [P, 8] x [N, 8] int32 -> [P, N] int32.

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    if d1.device.type == "cpu" and d2.device.type == "cpu":
        return hamming_matrix_reference(d1, d2)
    kernels.require_cuda("hamming_matrix", d1, torch.int32, 2)
    kernels.require_cuda("hamming_matrix", d2, torch.int32, 2)
    if d1.device != d2.device:
        raise ValueError("hamming_matrix: tensors on different devices")
    if d1.shape[1] != 8 or d2.shape[1] != 8:
        raise ValueError(f"hamming_matrix: expected [*, 8] words, got "
                         f"{tuple(d1.shape)} and {tuple(d2.shape)}")
    p, n = d1.shape[0], d2.shape[0]
    if (p + 63) // 64 > 65535:
        raise ValueError(f"hamming_matrix: {p} rows exceed the grid")
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
