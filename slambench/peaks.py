"""The card's published peaks and the work of each hand-written kernel,
from the shapes of the call: the roofline's two quotients.

NVIDIA H100 SXM at its 700 W limit, data-sheet figures: 3.35 TB/s of
HBM, 67 T/s of 32-bit operations outside the tensor cores (the kernels'
f32 adds, multiplies, min/max and int32 work), and for the Hamming
kernel's binary tensor-core products 8 x the published int8 rate of
1,979 T/s (the b1 ``mma.m16n8k256`` issues at the s8 ``m16n8k32`` rate
with 8 x the bits; no binary rate is published). Work and bytes are
counted as the port's kernel table counts them: every input byte read
once, every output byte written once, operations per element of the
algorithm (not of the implementation).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch

__all__ = ["HBM_BYTES_PER_S", "F32_OPS_PER_S", "B1_MMA_OPS_PER_S", "bound_s",
           "fast_score_work", "hamming_gated_min_work", "orient_describe_work"]

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
B1_MMA_OPS_PER_S = 8 * 1979e12
EDGE = 19
HALF_PATCH = 15


def bound_s(n_bytes: float, n_ops: float, n_tc_ops: float = 0.0) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the memory rate and each kind of operation over its peak."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S, n_tc_ops / B1_MMA_OPS_PER_S)


def fast_score_work(batch: int, canvas_h: int, canvas_w: int, pad: int = EDGE):
    """(bytes, ops) of one FAST-9 launch over ``batch`` canvases: every
    canvas pixel read and every score written once; per score 16
    differences, per side the 16 nine-tap arc extrema shared (64 two-input
    min/max) and their max (15), and the max of the sides."""
    n_out = batch * (canvas_h - 2 * pad) * (canvas_w - 2 * pad)
    return 4.0 * (batch * canvas_h * canvas_w + n_out), 175.0 * n_out


def hamming_gated_min_work(batch: int, P: int, N: int):
    """(bytes, ops, b1 tensor-core ops) of one gated Hamming row-minimum
    launch over ``batch`` [P, 8] x [N, 8] problems: both descriptor sets
    and the gates read, the three [P] results written; per pair one
    256-bit and + popcount on the b1 tensor cores (2 x 256) and 10 gate and
    reduction operations."""
    return (batch * (32.0 * (P + N) + 34.0 * P + 17.0 * N), batch * 10.0 * P * N,
            batch * 512.0 * P * N)


def _disc(umax: Sequence[int]) -> torch.Tensor:
    r = HALF_PATCH
    return torch.tensor([(dy, dx) for dy in range(-r, r + 1)
                         for dx in range(-umax[abs(dy)], umax[abs(dy)] + 1)])


def orient_describe_work(canvas_hw: Tuple[int, int], canvas_yx: torch.Tensor,
                         sample_yx: torch.Tensor, umax: Sequence[int]):
    """(bytes, ops) of orienting and describing the keypoints of one canvas:
    ``canvas_yx [n, 2]`` their disc centres on the canvas, ``sample_yx [n,
    512, 2]`` their BRIEF sample pixels on the blurred canvas (of the
    canvas's shape). The distinct disc and sample pixels read, the
    coordinates, the pattern and the outputs; per keypoint the disc moments
    (5 operations a disc column and 91 more), 70 for the angle and the
    rotation's set-up, 19 a pattern point for its rotation, rounding and
    clamping, one compare a pair."""
    n = canvas_yx.shape[0]
    d = _disc(umax).to(canvas_yx.device)
    pix = (canvas_yx[:, None, 0] + d[:, 0]) * canvas_hw[1] + canvas_yx[:, None, 1] + d[:, 1]
    spix = sample_yx[..., 0] * canvas_hw[1] + sample_yx[..., 1]
    ops_per_kp = 5 * sum(umax[abs(dy)] for dy in range(-HALF_PATCH, HALF_PATCH + 1)) + 91
    n_bytes = 4.0 * (torch.unique(pix).numel() + torch.unique(spix).numel() + 4 * n
                     + 1024 + 9 * n)
    return n_bytes, float((ops_per_kp + 70 + 19 * 512 + 256) * n)
