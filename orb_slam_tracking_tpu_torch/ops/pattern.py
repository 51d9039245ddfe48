"""Static ORB tables: the BRIEF-256 pattern and the ``umax`` disc bounds.

Counterpart of ``orb_slam_tracking_tpu/ops/pattern.py``. The pattern is
the package's own copy of the JAX package's ``_brief_pattern.npy`` (a test
holds the two equal); ``umax`` is re-derived with the reference ctor's
construction (``ORBextractor.cpp:562-594``).
"""

from __future__ import annotations

import functools
import os

import numpy as np

__all__ = ["HALF_PATCH_SIZE", "PATCH_SIZE", "EDGE_THRESHOLD",
           "brief_pattern", "umax_table"]

HALF_PATCH_SIZE = 15
PATCH_SIZE = 31
EDGE_THRESHOLD = 19  # ORBextractor.cpp:90

_PATTERN_PATH = os.path.join(os.path.dirname(__file__), "_brief_pattern.npy")


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 4] int32: (x1, y1, x2, y2) sample offsets, |coord| <= 13."""
    pat = np.load(_PATTERN_PATH)
    if pat.shape != (256, 4) or pat.dtype != np.int32:
        raise ValueError(f"bad BRIEF pattern {pat.shape} {pat.dtype}")
    pat.flags.writeable = False
    return pat


@functools.lru_cache(maxsize=1)
def umax_table() -> np.ndarray:
    """[HALF_PATCH_SIZE + 1] int32: max |u| per |v| for the r=15 disc."""
    r = HALF_PATCH_SIZE
    umax = np.zeros(r + 1, dtype=np.int32)
    vmax = int(np.floor(r * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(r * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(np.rint(np.sqrt(float(r * r) - v * v)))  # cvRound
    v0 = 0
    for v in range(r, vmin - 1, -1):  # mirror for symmetry
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    umax.flags.writeable = False
    return umax
