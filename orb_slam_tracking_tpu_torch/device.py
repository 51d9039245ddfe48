"""Where the port's entry points put their tensors.

Every entry point (``entry``, ``init_entry``, ``TrackingStep``,
``TwoViewInitializer``, ``ExtractorConstants``, ``gauss_taps``) runs on the
card unless the caller asks for the CPU with ``device="cpu"``.
"""

from __future__ import annotations

import torch

__all__ = ["DEFAULT_DEVICE", "full_f32", "resolve_device"]

DEFAULT_DEVICE = "cuda"


def resolve_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; raises if it is a CUDA device and
    this process has none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} was asked for but no CUDA device is "
            "available; pass device='cpu' to run on the CPU")
    return dev


def full_f32(device: torch.device) -> None:
    """On a CUDA device, turn both TF32 switches off for the process.

    The pose LM, the projections, the resize and the two-view solvers are
    f32 in the reference (ROADMAP C5): TF32 would keep ~3 decimal digits in
    their matrix products."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
