"""Carrying state between the JAX package and the port.

There are no model weights; the state a tracking step consumes is the map
(points, descriptors, validity, viewing normal, scale envelope), the pose
and the intrinsics, and the tracker's state is the full ``SlamMap``. The
pose and ``K`` are plain float32 tensors; these helpers turn the JAX
package's numpy maps into the port's tensors and back (uint32 descriptors
become int32 with the same bits) and the port's keypoints back and forth
between numpy and tensors, so both packages are fed and read identically.
"""

from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional

import numpy as np
import torch

from .slam.map import SlamMap
from .types import Keypoints

__all__ = ["MapTensors", "desc_to_int32", "desc_to_uint32", "map_from_numpy",
           "keypoints_from_numpy", "keypoints_to_numpy", "slam_map_from_numpy",
           "slam_map_to_numpy"]


class MapTensors(NamedTuple):
    pts: torch.Tensor     # [P, 3] float32 world points
    desc: torch.Tensor    # [P, 8] int32 descriptors
    valid: torch.Tensor   # [P] bool
    normal: torch.Tensor  # [P, 3] float32 mean viewing direction
    dmin: torch.Tensor    # [P] float32 scale-invariance distance envelope
    dmax: torch.Tensor    # [P] float32 (0 disables the frustum gates)


def desc_to_int32(desc: np.ndarray) -> np.ndarray:
    """uint32 descriptor words -> int32 words with the same bits."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype != np.uint32:
        raise TypeError(f"expected uint32 descriptors, got {desc.dtype}")
    return desc.view(np.int32)


def desc_to_uint32(desc: np.ndarray) -> np.ndarray:
    """int32 descriptor words -> the JAX package's uint32 words."""
    desc = np.ascontiguousarray(desc)
    if desc.dtype != np.int32:
        raise TypeError(f"expected int32 descriptors, got {desc.dtype}")
    return desc.view(np.uint32)


def map_from_numpy(pts: np.ndarray, desc: np.ndarray, valid: np.ndarray,
                   normal: Optional[np.ndarray] = None,
                   dmin: Optional[np.ndarray] = None,
                   dmax: Optional[np.ndarray] = None, *,
                   device: torch.device | str) -> MapTensors:
    """The JAX package's numpy map arrays -> the port's device tensors.
    Missing viewing statistics are zeros (gates off)."""
    p = len(pts)
    normal = np.zeros((p, 3), np.float32) if normal is None else normal
    dmin = np.zeros(p, np.float32) if dmin is None else dmin
    dmax = np.zeros(p, np.float32) if dmax is None else dmax

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=device)

    return MapTensors(
        pts=f32(pts),
        desc=torch.tensor(desc_to_int32(np.asarray(desc)), device=device),
        valid=torch.tensor(np.asarray(valid, bool), device=device),
        normal=f32(normal), dmin=f32(dmin), dmax=f32(dmax))


def keypoints_to_numpy(kps: Keypoints) -> Dict[str, np.ndarray]:
    """The port's keypoints as numpy, with the JAX package's dtypes
    (descriptors as uint32)."""
    out = {f: getattr(kps, f).detach().cpu().numpy() for f in kps._fields}
    out["desc"] = desc_to_uint32(out["desc"])
    return out


def keypoints_from_numpy(kps, *, device: torch.device | str) -> Keypoints:
    """The JAX package's keypoints (any mapping or NamedTuple of arrays with
    ``Keypoints``' fields, uint32 descriptors) -> the port's tensors."""
    get = kps.get if isinstance(kps, dict) else lambda f: getattr(kps, f)
    out = {f: np.asarray(get(f)) for f in Keypoints._fields}
    out["desc"] = desc_to_int32(out["desc"])
    return Keypoints(**{f: torch.tensor(a, device=device) for f, a in out.items()})


_DESC_FIELDS = ("desc", "kf_kp_desc")


def slam_map_to_numpy(m: SlamMap) -> Dict[str, np.ndarray]:
    """The port's ``SlamMap`` as the JAX package's numpy fields (descriptor
    words as uint32)."""
    out = {f: getattr(m, f).detach().cpu().numpy() for f in SlamMap._fields}
    for f in _DESC_FIELDS:
        out[f] = desc_to_uint32(out[f])
    return out


def slam_map_from_numpy(fields: Mapping[str, np.ndarray], *,
                        device: torch.device | str) -> SlamMap:
    """The JAX package's ``SlamMap`` fields (any mapping of numpy arrays,
    uint32 descriptors) -> the port's tensors."""
    out = {}
    for f in SlamMap._fields:
        a = np.asarray(fields[f])
        out[f] = torch.tensor(desc_to_int32(a) if f in _DESC_FIELDS else a, device=device)
    return SlamMap(**out)
