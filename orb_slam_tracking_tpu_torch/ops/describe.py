"""Orientation and rBRIEF description of keypoints in one pass.

``orient_describe`` is the wrapper of the CUDA kernel
``csrc/orient_describe.cu`` ("B4f"), which replaces the TPU kernel
``moments_at_pallas`` on the extractor's path together with what follows
it there: the angle, the rotated and rounded pattern, the rounded blurred
canvas and the sampler, compare and pack (``brief_sample_pallas``). On a
CPU tensor it runs ``orient_describe_reference``, the plain chain
``moments_at_reference`` -> ``angles_from_moments`` -> ``brief_coords`` /
``torch.round`` / ``brief_words_reference``; on a CUDA tensor it launches
the kernel, which equals that chain bit for bit.
``orient_describe.launches`` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from .. import kernels
from .brief import brief_coords, brief_words_reference
from .orientation import angles_from_moments, moments_at_reference
from .pattern import EDGE_THRESHOLD, HALF_PATCH_SIZE

__all__ = ["orient_describe", "orient_describe_reference"]


def orient_describe_reference(canvas: torch.Tensor, blurred: torch.Tensor,
                              yc: torch.Tensor, xc: torch.Tensor, xy: torch.Tensor,
                              pattern_xy: torch.Tensor, umax: Sequence[int],
                              pad: int = EDGE_THRESHOLD
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(angle_deg [N] float32, desc [N, 8] int32) of keypoints whose disc
    centres are the canvas pixels (yc, xc) [N] int32 and whose coords in
    the padded blurred canvas ``blurred`` [Hp, Wp] are ``xy`` [N, 2]
    (integer-valued float32, inside the pad); ``pattern_xy`` [2, 512]."""
    angle = angles_from_moments(*moments_at_reference(canvas, yc, xc, umax))
    sy, sx = brief_coords(xy, angle, pattern_xy, *blurred.shape, pad)
    # the reference blurs into CV_8U (ORBextractor.cpp:1113-1116): its bits
    # compare integer intensities
    return angle, brief_words_reference(torch.round(blurred), sy, sx)


def orient_describe(canvas: torch.Tensor, blurred: torch.Tensor, yc: torch.Tensor,
                    xc: torch.Tensor, xy: torch.Tensor, pattern_xy: torch.Tensor,
                    umax: Sequence[int], pad: int = EDGE_THRESHOLD
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Angles and descriptors: see ``orient_describe_reference``.

    A CPU tensor runs the plain version; CUDA tensors launch the kernel."""
    if canvas.device.type == "cpu":
        return orient_describe_reference(canvas, blurred, yc, xc, xy, pattern_xy, umax, pad)
    name = "orient_describe"
    kernels.require_cuda(name, canvas, torch.float32, 2)
    kernels.require_cuda(name, blurred, torch.float32, 2)
    kernels.require_cuda(name, yc, torch.int32, 1)
    kernels.require_cuda(name, xc, torch.int32, 1)
    kernels.require_cuda(name, xy, torch.float32, 2)
    kernels.require_cuda(name, pattern_xy, torch.float32, 2)
    if len({t.device for t in (canvas, blurred, yc, xc, xy, pattern_xy)}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    n = yc.shape[0]
    if xc.shape != (n,) or xy.shape != (n, 2):
        raise ValueError(f"{name}: yc {tuple(yc.shape)}, xc {tuple(xc.shape)} and xy "
                         f"{tuple(xy.shape)} do not describe the same N keypoints")
    if pattern_xy.shape != (2, 512):
        raise ValueError(f"{name}: expected a [2, 512] pattern, got {tuple(pattern_xy.shape)}")
    if len(umax) != HALF_PATCH_SIZE + 1 or not all(
            0 <= int(u) <= HALF_PATCH_SIZE for u in umax):
        raise ValueError(f"{name}: umax must hold {HALF_PATCH_SIZE + 1} half-widths in "
                         f"[0, {HALF_PATCH_SIZE}], got {umax}")
    angle = torch.empty(n, dtype=torch.float32, device=canvas.device)
    desc = torch.empty((n, 8), dtype=torch.int32, device=canvas.device)
    if n == 0:
        return angle, desc
    h, w = canvas.shape
    hp, wp = blurred.shape
    umax_c = (ctypes.c_int * (HALF_PATCH_SIZE + 1))(*(int(u) for u in umax))
    with torch.cuda.device(canvas.device):
        rc = kernels.library().osltt_orient_describe(
            canvas.data_ptr(), h, w, blurred.data_ptr(), hp, wp, yc.data_ptr(),
            xc.data_ptr(), xy.data_ptr(), pattern_xy.data_ptr(), umax_c, pad,
            angle.data_ptr(), desc.data_ptr(), n,
            torch.cuda.current_stream(canvas.device).cuda_stream)
    kernels.check_launch(name, rc)
    orient_describe.launches += 1
    return angle, desc


orient_describe.launches = 0
