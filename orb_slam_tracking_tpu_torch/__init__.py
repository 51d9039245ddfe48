"""orb_slam_tracking_tpu_torch — the PyTorch/CUDA port of the tracking engine.

The JAX package ``orb_slam_tracking_tpu`` is the reference; this package
mirrors its module names so each counterpart is easy to find. It imports
``torch`` and numpy, and nothing of ``jax`` or of the JAX package: the
configuration dataclasses, the BRIEF pattern and the synthetic scene are
its own copies, which the tests hold equal to the JAX package's.

The hot kernels (FAST score, BRIEF sampling + packing, Hamming matrix) are
CUDA C++ for Hopper under ``csrc/``, built with ``nvcc`` at first use from
a CUDA-tensor call (``kernels``). Each wrapper runs its plain PyTorch
version only for tensors that lie on the CPU.
"""

__version__ = "0.1.0"

from .config import (  # noqa: F401
    CameraConfig,
    MatcherConfig,
    OrbConfig,
    TrackerConfig,
)
