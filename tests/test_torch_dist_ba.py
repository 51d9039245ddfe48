"""The port's point-sharded Schur BA (``parallel/ba_sharded.py``) on gloo
ranks against the JAX package's ``bundle_adjust_sharded`` (its scatter
form) on the same number of virtual CPU devices, and against the port's
``optim.ba.bundle_adjust``, on the CPU.

The problem is ``synthetic_ba_problem(0xBA, 8, 512)`` (8 keyframes, 512
points, the first keyframe fixed, 10 iterations), bucketed by
``bucket_observations`` with 64 slots of slack a shard, as
``tests/test_distributed_multiprocess.py`` runs JAX's. The bounds are the
JAX tests' own sharded-vs-single bounds (``tests/test_parallel.py:78-79``,
``test_distributed_multiprocess.py:83-92``): the final cost to 1e-3
relative, R and t to 1e-3, the points to 5e-3. A world of 2 is spawned
once and solves the problem twice (the two solves must agree bit for bit)
and with a BA window; a world of 1 solves it once. The ranks import
nothing of jax.

With ``max_free_cams`` below the number of free cameras, JAX's sharded
program ties the cameras beyond the window to the window's last slot
(``ba_sharded.py:158-160, 275-279``) where its docstring and JAX's
single-device BA hold them fixed (ROADMAP C13); the port holds them
fixed, so that case is held to the single-device BAs, and JAX's sharded
program to them only with the window at the free-camera count.
"""

import functools
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.optim.ba import bundle_adjust
from orb_slam_tracking_tpu_torch.parallel import distributed
from orb_slam_tracking_tpu_torch.parallel.ba_sharded import (bucket_observations,
                                                            bundle_adjust_sharded)
from orb_slam_tracking_tpu_torch.utils.synthetic import (strong_scaling_ba_problem,
                                                         synthetic_ba_problem)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NK, NP, ITERS = 8, 512, 10
# windows: every free camera (7: the compact coupling), and fewer (4)
WINDOWS = (None, 7, 4)
REL_COST, ATOL_POSE, ATOL_PTS = 1e-3, 1e-3, 5e-3


@functools.lru_cache(maxsize=None)
def _problem():
    pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K = synthetic_ba_problem(0xBA, NK, NP)
    fixed = np.zeros(NK, bool)
    fixed[0] = True
    return pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K, fixed


def _bucketed(world):
    pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K, fixed = _problem()
    O = NK * NP
    return (kf_R0, kf_t0, pts0) + bucket_observations(
        obs_kf, obs_pt, obs_uv, np.ones(O, np.float32), np.ones(O, bool), NP, world,
        O // world + 64) + (fixed, np.ones(NP, bool), K)


def _ba_worker(mesh, args, windows, repeat):
    """One rank: the sharded BA at each window, the first one ``repeat``
    times; the cameras and cost, and the rank's points."""
    torch.set_num_threads(1)
    kf_R, kf_t, pts, bk, bp, buv, bw, bv, fixed, pv, K = args
    rep = functools.partial(distributed.replicate, mesh)
    shard = functools.partial(distributed.make_global_array, mesh)
    out = []
    for w in [windows[0]] * repeat + list(windows[1:]):
        out.append(bundle_adjust_sharded(
            rep(kf_R), rep(kf_t), shard(pts), shard(bk), shard(bp), shard(buv), shard(bw),
            shard(bv), rep(fixed), shard(pv), rep(K), iterations=ITERS, max_free_cams=w,
            group=mesh.group))
    return out, any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu") for m in sys.modules)


@functools.lru_cache(maxsize=None)
def _port(world):
    """({window: (R, t, points of the whole map, cost)}, the repeated
    solves of the first window)."""
    windows, repeat = (WINDOWS, 2) if world == 2 else ((None, 4), 1)
    ranks = distributed.spawn(_ba_worker, world, "gloo", "cpu",
                              (_bucketed(world), windows, repeat), timeout=300)
    assert not any(jx for _, jx in ranks)
    outs = [r for r, _ in ranks]
    for r in outs[1:]:        # the cameras and cost replicated bit for bit
        for a, b in zip(r, outs[0]):
            for i in (0, 1, 3):
                np.testing.assert_array_equal(a[i], b[i])
    runs = []
    for k in range(len(outs[0])):
        R, t, _, cost = outs[0][k]
        runs.append((R, t, np.concatenate([o[k][2] for o in outs]), float(cost)))
    ws = [windows[0]] * repeat + list(windows[1:])
    return dict(zip(ws, runs)), runs[:repeat]


def _port2():
    return _port(2)[0]


@functools.lru_cache(maxsize=None)
def _single(window):
    """The port's ``bundle_adjust`` on the unbucketed problem."""
    pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K, fixed = _problem()
    O = NK * NP
    T = torch.from_numpy
    r = bundle_adjust(T(kf_R0), T(kf_t0), T(pts0), T(obs_kf), T(obs_pt), T(obs_uv),
                      torch.ones(O), torch.ones(O, dtype=torch.bool), T(fixed),
                      torch.ones(NP, dtype=torch.bool), T(K), iterations=ITERS,
                      max_free_cams=window)
    return r.kf_R.numpy(), r.kf_t.numpy(), r.pts.numpy(), float(r.cost)


@functools.lru_cache(maxsize=None)
def _jax_sharded(world, window):
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu.parallel.ba_sharded import bundle_adjust_sharded as jx_ba
    from orb_slam_tracking_tpu.parallel.ba_sharded import make_ba_mesh

    kf_R, kf_t, pts, bk, bp, buv, bw, bv, fixed, pv, K = map(jnp.asarray, _bucketed(world))
    R, t, X, c = jx_ba(make_ba_mesh(jax.devices()[:world]), kf_R, kf_t, pts, bk, bp, buv, bw,
                       bv, fixed, pv, K, iterations=ITERS, max_free_cams=window,
                       segment_mode="scatter")
    return np.asarray(R), np.asarray(t), np.asarray(X), float(c)


@functools.lru_cache(maxsize=None)
def _jax_single(window):
    import jax.numpy as jnp

    from orb_slam_tracking_tpu.optim.ba import bundle_adjust as jx_bundle_adjust

    pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K, fixed = map(jnp.asarray, _problem())
    O = NK * NP
    r = jx_bundle_adjust(kf_R0, kf_t0, pts0, obs_kf, obs_pt, obs_uv, jnp.ones(O),
                         jnp.ones(O, bool), fixed, jnp.ones(NP, bool), K, iterations=ITERS,
                         max_free_cams=window, segment_mode="scatter")
    return np.asarray(r.kf_R), np.asarray(r.kf_t), np.asarray(r.pts), float(r.cost)


def _close(got, want):
    R, t, X, c = got
    Rw, tw, Xw, cw = want
    assert abs(c - cw) / cw < REL_COST, (c, cw)
    np.testing.assert_allclose(R, Rw, atol=ATOL_POSE, rtol=0)
    np.testing.assert_allclose(t, tw, atol=ATOL_POSE, rtol=0)
    np.testing.assert_allclose(X, Xw, atol=ATOL_PTS, rtol=0)


@pytest.mark.parametrize("n_dev,cap", [(8, 32), (4, 300), (2, 40)])
def test_bucket_observations_matches_jax(n_dev, cap):
    """The same arrays as JAX's, with invalid observations left out and
    (at (2, 40)) a shard's overflow dropped."""
    from orb_slam_tracking_tpu.parallel.ba_sharded import bucket_observations as jx_bucket

    rng = np.random.default_rng(n_dev)
    O, nP = 300, 64
    args = (rng.integers(0, 4, O).astype(np.int32), rng.integers(0, nP, O).astype(np.int32),
            rng.uniform(0, 100, (O, 2)).astype(np.float32),
            rng.uniform(0.5, 1, O).astype(np.float32), rng.random(O) < 0.9)
    got = bucket_observations(*args, nP, n_dev, cap)
    want = jx_bucket(*args, nP, n_dev, cap)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)


def test_strong_scaling_problem_matches_the_script():
    """``strong_scaling_ba_problem`` draws the JAX package's
    ``scripts/scaling_efficiency.py`` problem."""
    spec = importlib.util.spec_from_file_location(
        "jx_scaling_efficiency", os.path.join(REPO, "scripts", "scaling_efficiency.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    want = mod._ba_problem(np.random.default_rng(0))
    got = strong_scaling_ba_problem(0)
    assert len(got) == len(want) + 1
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].shape == (40960,)


@pytest.mark.parametrize("window", (None, 7))
def test_sharded_ba_matches_jax_sharded(window):
    """World 2 against JAX's sharded program on 2 devices."""
    _close(_port2()[window], _jax_sharded(2, window))


@pytest.mark.parametrize("window", WINDOWS)
def test_sharded_ba_matches_bundle_adjust(window):
    """World 2 against the port's and JAX's single-device BA, the window
    below the free-camera count included (cameras beyond it held fixed)."""
    got = _port2()[window]
    _close(got, _single(window))
    _close(got, _jax_single(window))
    if window == 4:
        kf_t0 = _problem()[2]
        np.testing.assert_array_equal(got[1][5:], kf_t0[5:])


def test_jax_sharded_window_fault_pinned():
    """C13: JAX's sharded program with the window below the free-camera
    count parts from its own single-device BA beyond the bounds (the
    cameras past the window move with the last slot), which the port does
    not follow."""
    jx_sh, jx_one = _jax_sharded(2, 4), _jax_single(4)
    assert abs(jx_sh[3] - jx_one[3]) / jx_one[3] > REL_COST
    assert np.abs(jx_sh[1][5:] - _problem()[2][5:]).max() > ATOL_POSE


@pytest.mark.parametrize("window", (None, 4))
def test_sharded_ba_world1_matches_world2(window):
    _close(_port(1)[0][window], _port2()[window])


def test_sharded_ba_repeats_bit_for_bit():
    runs = _port(2)[1]
    assert len(runs) == 2
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)


def test_sharded_ba_refuses_tpu_forms():
    """Only the scatter form is ported: the TPU forms raise before any
    collective."""
    args = tuple(torch.from_numpy(np.asarray(a)) for a in _bucketed(1))
    with pytest.raises(ValueError, match="scatter"):
        bundle_adjust_sharded(*args, segment_mode="cammajor")
