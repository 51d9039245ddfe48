"""The port's multi-sequence mapping runner with its batch spread over two
gloo CPU ranks (``parallel.multiseq.make_multiseq_mapping_runner(...,
group=)``).

``tests/test_torch_multiseq_mapping.py``'s scene: two distinct sequences
(their own corner fields and starts on the strafe, maps seeded from
ground truth) at 320x240 with 4 pyramid levels, 2 frames with an insert
on each. Each rank runs its one sequence as a batch of one (the batched
step), and the gathered maps and outputs are one process's [B] run bit
for bit, and JAX's runner sharded over a 2-device mesh within that file's
bounds.

The ranks import this file, so JAX is imported inside the tests only.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from orb_slam_tracking_tpu_torch.convert import slam_map_from_numpy
from orb_slam_tracking_tpu_torch.parallel import distributed, multiseq
from orb_slam_tracking_tpu_torch.slam.map import SlamMap

CAM = CameraConfig(fx=288.0, fy=288.0, cx=160.0, cy=120.0, width=320, height=240)
OCFG = OrbConfig(n_features=300, n_levels=4, select_cell_size=10, max_keypoints=320)
TCFG = TrackerConfig(max_map_points=512, max_keyframes=8, ba_window=3, ba_iterations=2,
                     min_frames=0, max_frames=3, min_tracked_inliers=15, covis_min_shared=8,
                     use_loop_closing=False, use_bow=False, local_map_radius=6.0)
CAPS = {"tri_cap": 32, "obs_cap": 64}
B = 2
T = 2


def _run(group, maps, images, R0, t0, K, n_seed):
    """The mapping runner over ``group`` (None: this process) on the B
    maps (numpy field dicts)."""
    run = multiseq.make_multiseq_mapping_runner(CAM, OCFG, MatcherConfig(), TCFG, device="cpu",
                                                group=group, **CAPS)
    m0 = SlamMap(*(torch.stack(x) for x in zip(*(slam_map_from_numpy(m, device="cpu")
                                                 for m in maps))))
    n = len(maps)
    return run(torch.from_numpy(images), m0, torch.from_numpy(R0), torch.from_numpy(t0),
               torch.from_numpy(K), [1] * n, [1] * n, list(n_seed))


def _worker(mesh, *args):
    torch.set_num_threads(1)
    foreign = any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu") for m in sys.modules)
    return _run(mesh.group, *args), foreign


def _scene():
    from test_torch_multiseq_mapping import _scene as scene

    maps, images, R0, t0, K, n_seed = scene()
    np_maps = [{f: np.asarray(getattr(m, f)) for f in m._fields} for m in maps]
    return maps, (np_maps, np.ascontiguousarray(images[:, :T]), R0, t0, K, list(n_seed))


@functools.lru_cache(maxsize=1)
def _runs():
    """(the two ranks' results, one process's [B] run, JAX's 2-device run)."""
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu import config as jx_config
    from orb_slam_tracking_tpu.parallel.multiseq import make_dp_mesh
    from orb_slam_tracking_tpu.parallel.multiseq import \
        make_multiseq_mapping_runner as jx_mapping_runner
    from test_torch_dist_multiseq_init import _in_thread
    from test_torch_multiseq_mapping import _jx

    jmaps, args = _scene()
    # the ranks run while this process runs the references
    ranks = _in_thread(lambda: distributed.spawn(_worker, 2, "gloo", "cpu", args, timeout=300))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        m1, o1 = _run(None, *args)
    finally:
        torch.set_num_threads(n)
    one = ({f: getattr(m1, f).numpy() for f in m1._fields},
           {f: getattr(o1, f).numpy() for f in o1._fields})
    _, images, R0, t0, K, n_seed = args
    run = jx_mapping_runner(make_dp_mesh(jax.devices()[:2]), _jx(CAM), _jx(OCFG),
                            jx_config.MatcherConfig(), _jx(TCFG), **CAPS)
    mB = jax.tree.map(lambda *a: jnp.stack(a), *jmaps)
    ones = jnp.ones((B,), jnp.int32)
    jm, jo = run(jnp.asarray(images), mB, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(K),
                 ones, ones, jnp.asarray(n_seed, jnp.int32))
    ref = ({f: np.asarray(getattr(jm, f)) for f in jm._fields},
           {f: np.asarray(getattr(jo, f)) for f in jo._fields})
    return ranks(), one, ref


def test_mapping_runner_across_ranks_equals_one_process():
    """Every rank returns every sequence's final map and outputs, bit for
    bit one process's [B] run (bool fields included); the ranks load
    nothing of JAX."""
    ranks, (m1, o1), _ = _runs()
    assert o1["inserted_kf"].sum(1).min() >= 1 and not o1["lost"].any()
    for (m, o), foreign in ranks:
        assert not foreign
        for got, want in ((m._asdict(), m1), (o._asdict(), o1)):
            assert set(got) == set(want)
            for k in want:
                assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
                np.testing.assert_array_equal(got[k], want[k], k)


def test_mapping_runner_across_ranks_matches_jax_sharded():
    """Against JAX's runner sharded over 2 devices, with the bounds of
    test_torch_multiseq_mapping: the same keyframe inserts, lost frames,
    keypoint counts and final keyframe sets, n_inliers within 3 % + 3,
    poses within 2e-3."""
    ranks, _, (jm, jo) = _runs()
    m, o = ranks[1][0]
    for f in ("inserted_kf", "lost", "n_kps"):
        np.testing.assert_array_equal(getattr(o, f), jo[f], f)
    assert o.inserted_kf.sum(1).min() >= 1
    assert (np.abs(o.n_inliers - jo["n_inliers"]) <= 0.03 * jo["n_inliers"] + 3).all()
    np.testing.assert_allclose(o.R, jo["R"], atol=2e-3, rtol=0)
    np.testing.assert_allclose(o.t, jo["t"], atol=2e-3, rtol=0)
    for f in ("kf_valid", "kf_frame_id"):
        np.testing.assert_array_equal(getattr(m, f), jm[f], f)


def _odd_worker(mesh, maps, images, R0, t0, K, n_seed):
    return _run(mesh.group, maps[:1] * 3, np.concatenate([images[:1]] * 3), R0[:1].repeat(3, 0),
                t0[:1].repeat(3, 0), K, [n_seed[0]] * 3)


def test_mapping_runner_batch_must_divide_the_ranks():
    """B = 3 over 2 ranks raises on every rank before any collective."""
    _, args = _scene()
    with pytest.raises(RuntimeError, match="3 sequences do not divide over 2 ranks"):
        distributed.spawn(_odd_worker, 2, "gloo", "cpu", args, timeout=120)
