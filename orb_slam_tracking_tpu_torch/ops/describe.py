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

Leading batch axes (``canvas [B, H, W]``, ``blurred [B, Hp, Wp]``, ``yc``,
``xc`` ``[B, N]``, ``xy [B, N, 2]``, the pattern shared) orient and
describe the B x N keypoints of B canvases in one launch, each keypoint
reading its own canvas; the plain version then runs the chain per canvas.
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
    (integer-valued float32, inside the pad); ``pattern_xy`` [2, 512].
    With a leading [B] on all but the pattern, canvas by canvas: a CPU's
    vector math may round an angle by its place in a batch, and each
    canvas then sees exactly its single call."""
    if canvas.dim() == 3:
        outs = [orient_describe_reference(*a, pattern_xy, umax, pad)
                for a in zip(canvas, blurred, yc, xc, xy)]
        return (torch.stack([a for a, _ in outs]), torch.stack([d for _, d in outs]))
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
    lead = canvas.shape[:-2]
    if len(lead) > 1:
        raise ValueError(f"{name}: expected [H, W] or [B, H, W] canvases, got "
                         f"{tuple(canvas.shape)}")
    nb = len(lead)
    kernels.require_cuda(name, canvas, torch.float32, 2 + nb)
    kernels.require_cuda(name, blurred, torch.float32, 2 + nb)
    kernels.require_cuda(name, yc, torch.int32, 1 + nb)
    kernels.require_cuda(name, xc, torch.int32, 1 + nb)
    kernels.require_cuda(name, xy, torch.float32, 2 + nb)
    kernels.require_cuda(name, pattern_xy, torch.float32, 2)
    if len({t.device for t in (canvas, blurred, yc, xc, xy, pattern_xy)}) != 1:
        raise ValueError(f"{name}: tensors on different devices")
    if blurred.shape[:-2] != lead:
        raise ValueError(f"{name}: {tuple(canvas.shape)} canvases, {tuple(blurred.shape)} "
                         f"blurred")
    n = yc.shape[-1]
    if xc.shape != lead + (n,) or xy.shape != lead + (n, 2) or yc.shape != lead + (n,):
        raise ValueError(f"{name}: yc {tuple(yc.shape)}, xc {tuple(xc.shape)} and xy "
                         f"{tuple(xy.shape)} do not describe the same N keypoints")
    if pattern_xy.shape != (2, 512):
        raise ValueError(f"{name}: expected a [2, 512] pattern, got {tuple(pattern_xy.shape)}")
    if len(umax) != HALF_PATCH_SIZE + 1 or not all(
            0 <= int(u) <= HALF_PATCH_SIZE for u in umax):
        raise ValueError(f"{name}: umax must hold {HALF_PATCH_SIZE + 1} half-widths in "
                         f"[0, {HALF_PATCH_SIZE}], got {umax}")
    angle = torch.empty(lead + (n,), dtype=torch.float32, device=canvas.device)
    desc = torch.empty(lead + (n, 8), dtype=torch.int32, device=canvas.device)
    batch = lead[0] if nb else 1
    if n == 0 or batch == 0:
        return angle, desc
    h, w = canvas.shape[-2:]
    hp, wp = blurred.shape[-2:]
    umax_c = (ctypes.c_int * (HALF_PATCH_SIZE + 1))(*(int(u) for u in umax))
    with torch.cuda.device(canvas.device):
        rc = kernels.library().osltt_orient_describe(
            canvas.data_ptr(), h, w, blurred.data_ptr(), hp, wp, yc.data_ptr(),
            xc.data_ptr(), xy.data_ptr(), pattern_xy.data_ptr(), umax_c, pad,
            angle.data_ptr(), desc.data_ptr(), batch, n,
            torch.cuda.current_stream(canvas.device).cuda_stream)
    kernels.check_launch(name, rc)
    orient_describe.launches += 1
    return angle, desc


orient_describe.launches = 0
