"""Rotated-BRIEF 256-bit descriptors (counterpart of ``ops/brief.py``).

``brief_coords`` rotates the pattern by each keypoint's angle and rounds
it (``cvRound``) into integer sample coordinates; ``brief_words`` samples,
compares and packs at them: the wrapper of the CUDA kernel
``csrc/brief_words.cu`` (which replaces the TPU kernel
``brief_sample_pallas`` and fuses its consumer, the compare and
``pack_bits``). On a CPU tensor ``brief_words`` runs
``brief_words_reference``, the plain gather -> compare -> pack.
``brief_words.launches`` counts the kernel's launches. The extractor's
path takes all of this, with the orientation, in one kernel
(``ops/describe.py``), whose plain version is built from these functions.

Bit k of word j is pair j*32 + k; words are int32 with the bits of the JAX
package's uint32.
"""

from __future__ import annotations

import torch

from .. import kernels
from .pattern import EDGE_THRESHOLD

__all__ = ["brief_coords", "brief_words", "brief_words_reference", "pack_bits"]


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32, little-endian bit order per word."""
    n = bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (bits.reshape(n, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def brief_words_reference(img: torch.Tensor, sy: torch.Tensor,
                          sx: torch.Tensor) -> torch.Tensor:
    """img [Hp, Wp] float32; sy, sx [N, 512] int32 (clamped to the image)
    -> [N, 8] int32: bit i = img[p_i] < img[p_{256+i}]."""
    hp, wp = img.shape
    yi = sy.to(torch.int64).clamp(0, hp - 1)
    xi = sx.to(torch.int64).clamp(0, wp - 1)
    vals = img.reshape(-1)[yi * wp + xi]
    return pack_bits(vals[:, :256] < vals[:, 256:])


def brief_words(img: torch.Tensor, sy: torch.Tensor,
                sx: torch.Tensor) -> torch.Tensor:
    """Sample, compare and pack: see ``brief_words_reference``.

    A CPU tensor runs the plain version; CUDA tensors launch the kernel.
    """
    if img.device.type == "cpu":
        return brief_words_reference(img, sy, sx)
    kernels.require_cuda("brief_words", img, torch.float32, 2)
    kernels.require_cuda("brief_words", sy, torch.int32, 2)
    kernels.require_cuda("brief_words", sx, torch.int32, 2)
    n = sy.shape[0]
    if sy.shape != (n, 512) or sx.shape != (n, 512):
        raise ValueError(f"brief_words: expected [N, 512] coordinates, got "
                         f"{tuple(sy.shape)} and {tuple(sx.shape)}")
    if not (img.device == sy.device == sx.device):
        raise ValueError("brief_words: tensors on different devices")
    out = torch.empty((n, 8), dtype=torch.int32, device=img.device)
    if n == 0:
        return out
    hp, wp = img.shape
    with torch.cuda.device(img.device):
        rc = kernels.library().osltt_brief_words(
            img.data_ptr(), hp, wp, sy.data_ptr(), sx.data_ptr(),
            out.data_ptr(), n, torch.cuda.current_stream(img.device).cuda_stream)
    kernels.check_launch("brief_words", rc)
    brief_words.launches += 1
    return out


brief_words.launches = 0


def brief_coords(xy: torch.Tensor, angle_deg: torch.Tensor,
                 pattern_xy: torch.Tensor, hp: int, wp: int,
                 pad: int = EDGE_THRESHOLD):
    """Absolute sample coordinates (sy, sx), each [N, 512] int32, of the
    pattern rotated by each keypoint's angle and rounded like the
    reference's ``cvRound``. ``xy`` [N, 2] are integer-valued level-local
    coords inside an image padded by ``pad`` to [hp, wp]; ``pattern_xy``
    [2, 512] holds the pattern's x row and y row (the first 256 columns
    are the first point of each pair)."""
    px, py = pattern_xy[0], pattern_xy[1]
    theta = torch.deg2rad(angle_deg)
    ca, sa = torch.cos(theta), torch.sin(theta)
    rx = torch.round(px[None, :] * ca[:, None] - py[None, :] * sa[:, None])
    ry = torch.round(px[None, :] * sa[:, None] + py[None, :] * ca[:, None])
    sx = ((xy[:, 0:1] + rx).to(torch.int32) + pad).clamp(0, wp - 1)
    sy = ((xy[:, 1:2] + ry).to(torch.int32) + pad).clamp(0, hp - 1)
    return sy.contiguous(), sx.contiguous()
