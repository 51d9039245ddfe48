"""The port's multi-sequence bootstrap with its batch spread over two gloo
CPU ranks (``parallel.multiseq.make_multiseq_init_runner(..., group=)``).

``tests/test_torch_multiseq_init.py``'s scene and draws: B = 2 sequences
of T = 6 frames at 640x480 (sequence 1 starts with a blank frame and sees
the strafe one frame late), JAX's uniforms of (sequence, frame) handed to
``MultiseqInitRunner.uniforms``. Each rank runs its one sequence as a
batch of one; its draws are those of its place in the whole batch, so the
gathered result is one process's [B] run bit for bit, and JAX's runner
sharded over a 2-device mesh within that file's bounds.

The ranks import this file, so JAX is imported inside the tests only.
"""

import functools
import sys
import threading

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.config import (CameraConfig, InitConfig, MatcherConfig,
                                                OrbConfig, TrackerConfig)
from orb_slam_tracking_tpu_torch.parallel import distributed, multiseq
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame

CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
OCFG = OrbConfig(n_features=1000)
ICFG = InitConfig(min_matches=60, ransac_iterations=150)
PC = 512
T = 6
B = 2


@functools.lru_cache(maxsize=1)
def _scene():
    field = CornerField(np.random.default_rng(0), n=500)
    poses = make_trajectory(16, "strafe")
    frames = np.stack([render_frame(field, CAM, R, t) for R, t in poses[:T]]).astype(np.float32)
    late = np.concatenate([np.zeros_like(frames[:1]), frames[:T - 1]])
    K = np.array([[CAM.fx, 0, CAM.cx], [0, CAM.fy, CAM.cy], [0, 0, 1]], np.float32)
    return np.stack([frames, late]), K, poses


def _run(group, images, K, draws):
    """The init runner over ``group`` (None: this process), ``draws[b][f]``
    the uniforms of sequence b at frame f."""
    run = multiseq.make_multiseq_init_runner(CAM, OCFG, MatcherConfig(), TrackerConfig(), ICFG,
                                             point_capacity=PC, device="cpu", group=group)
    run.uniforms = lambda b, f: tuple(torch.tensor(u) for u in draws[b][f])
    return run(torch.from_numpy(images), torch.from_numpy(K), list(range(images.shape[0])))


def _in_thread(fn):
    """``fn()`` started in a thread; returns a function that joins it and
    returns its result or raises its exception."""
    out = []

    def target():
        try:
            out.append((True, fn()))
        except Exception as e:  # re-raised by the caller
            out.append((False, e))

    th = threading.Thread(target=target)
    th.start()

    def result():
        th.join(timeout=600)
        assert not th.is_alive()
        ok, value = out[0]
        if not ok:
            raise value
        return value

    return result


def _worker(mesh, images, K, draws):
    torch.set_num_threads(1)
    foreign = any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu") for m in sys.modules)
    return _run(mesh.group, images, K, draws), foreign


@functools.lru_cache(maxsize=1)
def _runs():
    """(the two ranks' results, one process's [B] run, JAX's 2-device run)."""
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu import config as jx_config
    from orb_slam_tracking_tpu.parallel.multiseq import make_dp_mesh
    from orb_slam_tracking_tpu.parallel.multiseq import \
        make_multiseq_init_runner as jx_init_runner
    from test_torch_multiseq_init import _draws, _jx

    images, K, _ = _scene()
    draws = [_draws(b, T) for b in range(B)]
    # the ranks run while this process runs the references
    ranks = _in_thread(lambda: distributed.spawn(_worker, 2, "gloo", "cpu", (images, K, draws), timeout=300))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        one = {k: v.numpy() for k, v in _run(None, images, K, draws).items()}
    finally:
        torch.set_num_threads(n)
    keys = np.stack([np.asarray(jax.random.PRNGKey(b)) for b in range(B)]).astype(np.uint32)
    jx = jx_init_runner(make_dp_mesh(jax.devices()[:2]), _jx(CAM), _jx(OCFG),
                        jx_config.MatcherConfig(), jx_config.TrackerConfig(), _jx(ICFG),
                        point_capacity=PC)
    ref = {k: np.asarray(v) for k, v in jx(jnp.asarray(images), jnp.asarray(K),
                                           jnp.asarray(keys)).items()}
    return ranks(), one, ref


def test_init_runner_across_ranks_equals_one_process():
    """Every rank returns the whole batch, bit for bit one process's [B]
    run; the ranks load nothing of JAX."""
    ranks, one, _ = _runs()
    assert one["initialized"].all()
    for got, foreign in ranks:
        assert not foreign
        assert set(got) == set(one)
        for k in one:
            assert got[k].dtype == one[k].dtype and got[k].shape == one[k].shape, k
            np.testing.assert_array_equal(got[k], one[k], k)


def test_init_runner_across_ranks_matches_jax_sharded():
    """Against JAX's runner sharded over 2 devices, with the bounds of
    test_torch_multiseq_init: the same states, initialization frames,
    match counts and triangulated sets, equal map descriptors, every
    rotation within 1e-3, and each tracked translation's direction within
    5 degrees and its norm within 2 %."""
    ranks, _, ref = _runs()
    got = ranks[0][0]
    assert ref["initialized"].all() and ref["init_frame"][1] == ref["init_frame"][0] + 1
    for k in ("state", "initialized", "init_frame", "n_matches", "map_valid"):
        np.testing.assert_array_equal(got[k], ref[k], k)
    valid = ref["map_valid"]
    np.testing.assert_array_equal(got["map_desc"][valid], ref["map_desc"].view(np.int32)[valid])
    np.testing.assert_allclose(got["R"], ref["R"], atol=1e-3, rtol=0)
    for b in range(B):
        for f in range(int(ref["init_frame"][b]), T):
            t, tr = got["t"][b, f].astype(np.float64), ref["t"][b, f].astype(np.float64)
            cos = t @ tr / (np.linalg.norm(t) * np.linalg.norm(tr))
            assert np.degrees(np.arccos(min(cos, 1.0))) < 5.0, (b, f)
            assert abs(np.linalg.norm(t) / np.linalg.norm(tr) - 1) < 0.02, (b, f)


def _odd_worker(mesh, images, K):
    run = multiseq.make_multiseq_init_runner(CAM, OCFG, MatcherConfig(), TrackerConfig(), ICFG,
                                             point_capacity=PC, device="cpu", group=mesh.group)
    return run(torch.from_numpy(images), torch.from_numpy(K), [0, 1, 2])


def test_init_runner_batch_must_divide_the_ranks():
    """B = 3 over 2 ranks raises on every rank before any collective."""
    images, K, _ = _scene()
    three = np.concatenate([images, images[:1]])[:, :1]
    with pytest.raises(RuntimeError, match="3 sequences do not divide over 2 ranks"):
        distributed.spawn(_odd_worker, 2, "gloo", "cpu", (three, K), timeout=120)
