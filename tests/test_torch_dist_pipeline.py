"""The port's two-stage tracking pipeline (``parallel/pipeline.py``) on 2
gloo ranks against the JAX package's ``make_pipelined_tracker`` on 2
virtual CPU devices, and against the port's own sequential step, on the
CPU.

The scene is ``tests/test_pipeline.py``'s (``_build_scene``, seed 7: the
500-point field, 5 frames of the 16-pose strafe, 300 features, the
frame-0 map associated to ground truth within 3 px). The pipeline must
equal ``pipeline.track_sequential`` (the same ``TrackingStep`` and
constant-velocity carry one frame after another) bit for bit on both
ranks, and JAX's pipeline within the bounds ``tests/test_torch_track.py``
holds the port's step to JAX's (R to 1e-4, t to 1e-3) with the same
inlier counts. Groups of 1 and 3 ranks raise ``ValueError``. The ranks
import nothing of jax.
"""

import functools
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from orb_slam_tracking_tpu_torch.config import (CameraConfig, MatcherConfig, OrbConfig,
                                                TrackerConfig)
from orb_slam_tracking_tpu_torch.parallel import distributed
from orb_slam_tracking_tpu_torch.parallel.pipeline import (make_pipelined_tracker,
                                                          track_sequential)
from orb_slam_tracking_tpu_torch.slam.fused_step import TrackingStep

_CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
_OCFG = OrbConfig(n_features=300)
_T = 5


@functools.lru_cache(maxsize=1)
def _scene():
    """The pipeline's arguments as numpy (``map_desc`` int32) and the
    ground-truth poses."""
    from orb_slam_tracking_tpu import config as jx_config
    from test_pipeline import _build_scene

    jcam = jx_config.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    frames, pts, desc, valid, poses, P = _build_scene(
        np.random.default_rng(7), jcam, jx_config.OrbConfig(n_features=300), _T)
    R0, t0 = poses[0]
    K = np.array([[_CAM.fx, 0, _CAM.cx], [0, _CAM.fy, _CAM.cy], [0, 0, 1]], np.float32)
    zn, zd = np.zeros((P, 3), np.float32), np.zeros(P, np.float32)
    return (frames, pts, desc.view(np.int32), valid, zn, zd, zd, R0.astype(np.float32),
            t0.astype(np.float32), K), poses


def _pp_worker(mesh, args):
    torch.set_num_threads(1)
    run = make_pipelined_tracker(mesh.group, _CAM, _OCFG, MatcherConfig(), TrackerConfig(),
                                 device=mesh.device)
    out = run(*(torch.from_numpy(a) for a in args))
    return out, run.stage, any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu")
                               for m in sys.modules)


def _group_size_worker(mesh):
    """Every rank forms a 1-rank group; rank 0 builds the pipeline on it,
    every rank on the 3-rank default group: both must raise."""
    one = dist.new_group([0])
    raised = []
    for group in ([one] if mesh.rank == 0 else []) + [None]:
        try:
            make_pipelined_tracker(group, _CAM, _OCFG, MatcherConfig(), TrackerConfig(),
                                   device="cpu")
            raised.append(False)
        except ValueError:
            raised.append(True)
    return raised


@functools.lru_cache(maxsize=1)
def _port():
    return distributed.spawn(_pp_worker, 2, "gloo", "cpu", (_scene()[0],), timeout=300)


@functools.lru_cache(maxsize=1)
def _sequential():
    torch.set_num_threads(1)
    step = TrackingStep(_CAM, _OCFG, MatcherConfig(), TrackerConfig(), device="cpu")
    return track_sequential(step, *(torch.from_numpy(a) for a in _scene()[0]))


@functools.lru_cache(maxsize=1)
def _jax():
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu import config as jx_config
    from orb_slam_tracking_tpu.parallel.pipeline import make_pipelined_tracker as jx_pp
    from orb_slam_tracking_tpu.parallel.pipeline import make_pp_mesh

    args = list(_scene()[0])
    args[2] = args[2].view(np.uint32)
    jcam = jx_config.CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
    run = jx_pp(make_pp_mesh(jax.devices()[:2]), jcam, jx_config.OrbConfig(n_features=300),
                jx_config.MatcherConfig(), jx_config.TrackerConfig())
    out = run(*map(jnp.asarray, args))
    return {f: np.asarray(getattr(out, f)) for f in out._fields}


def test_pipeline_equals_sequential_bit_for_bit():
    ranks, seq = _port(), _sequential()
    assert sorted(stage for _, stage, _ in ranks) == [0, 1]
    assert not any(jx for _, _, jx in ranks)
    for out, _, _ in ranks:
        for f in seq._fields:
            np.testing.assert_array_equal(getattr(out, f), getattr(seq, f).numpy(), f)
    assert seq.R.shape == (_T, 3, 3)
    assert int(seq.n_inliers.min()) >= 10


@pytest.mark.parametrize("frame", range(_T))
def test_pipeline_matches_jax(frame):
    got, ref = _port()[0][0], _jax()
    np.testing.assert_allclose(got.R[frame], ref["R"][frame], atol=1e-4, rtol=0)
    np.testing.assert_allclose(got.t[frame], ref["t"][frame], atol=1e-3, rtol=0)
    assert got.n_inliers[frame] == ref["n_inliers"][frame]
    assert got.n_kps[frame] == ref["n_kps"][frame]
    assert abs(int(got.n_matches[frame]) - int(ref["n_matches"][frame])) <= 2
    # and the stream still tracks ground truth (tests/test_pipeline.py)
    Rg, tg = _scene()[1][frame]
    err = np.degrees(np.arccos(np.clip((np.trace(got.R[frame].T @ Rg) - 1) / 2, -1, 1)))
    assert err < 1.5 and np.linalg.norm(got.t[frame] - tg) < 0.08


def test_pipeline_group_sizes_raise():
    """JAX's ``test_pp_mesh_requires_two_stages``: one stage or three are
    refused."""
    raised = distributed.spawn(_group_size_worker, 3, "gloo", "cpu", timeout=300)
    assert raised == [[True, True], [True], [True]]
