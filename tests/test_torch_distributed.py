"""The port's process-group plumbing (``parallel/distributed.py``), the
multi-sequence runners' DP across ranks and ``entry.dryrun_multichip``, on
gloo CPU ranks.

``make_global_array`` / ``replicate`` are held to the JAX package's
layout (each device's shard of a ``NamedSharding`` over a 1-D mesh). DP
across 2 ranks runs ``tests/test_torch_multiseq.py``'s scene (its
500-point field, 16-pose strafe and frame-0 map, 300 features) at B = 4
distinct sequences of 3 frames, each rank its 2: the step and the
frozen-map sequence runner must return, on every rank, the whole batch
exactly as one process's [B] run (the bound that file holds a [B] run to
B single runs: exact on the CPU).
"""

import functools
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.config import (CameraConfig, MatcherConfig, OrbConfig,
                                                TrackerConfig)
from orb_slam_tracking_tpu_torch.entry import dryrun_multichip
from orb_slam_tracking_tpu_torch.ops.extractor import orb_extract
from orb_slam_tracking_tpu_torch.parallel import distributed, multiseq
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame

_CAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
_OCFG = OrbConfig(n_features=300)
B, _ST = 4, 3


def _foreign():
    return any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu") for m in sys.modules)


def test_initialize_from_env_is_a_noop_for_one_process(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert distributed.initialize_from_env(backend="gloo") is False
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", "29500")  # one process: nothing binds it
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    assert distributed.initialize_from_env(backend="gloo") is False
    assert not torch.distributed.is_initialized()
    assert distributed.process_index() == 0 and distributed.process_count() == 1
    with pytest.raises(RuntimeError, match="no process group"):
        distributed.global_mesh(device="cpu")


@pytest.mark.parametrize("world", (2, 4, 8))
def test_global_array_layout_matches_jax(world):
    """Rank r's ``make_global_array`` slice is the data of device r's shard
    of JAX's ``make_global_array`` over ``world`` devices; ``replicate``
    gives every rank the whole array."""
    import jax

    from orb_slam_tracking_tpu.parallel.distributed import global_mesh as jx_mesh
    from orb_slam_tracking_tpu.parallel.distributed import make_global_array as jx_global
    from orb_slam_tracking_tpu.parallel.distributed import replicate as jx_replicate

    host = np.random.default_rng(world).normal(size=(8 * world, 3)).astype(np.float32)
    mesh = jx_mesh("points")
    sub = jax.sharding.Mesh(np.asarray(jax.devices()[:world]), ("points",))
    shards = {s.device: np.asarray(s.data) for s in jx_global(sub, "points", host).addressable_shards}
    whole = jx_replicate(mesh, host)
    for r, dev in enumerate(sub.devices.reshape(-1)):
        m = distributed.Mesh(None, "points", r, world, torch.device("cpu"))
        np.testing.assert_array_equal(distributed.make_global_array(m, host).numpy(), shards[dev])
        np.testing.assert_array_equal(distributed.replicate(m, host).numpy(), np.asarray(whole))
    with pytest.raises(ValueError, match="divide"):
        distributed.make_global_array(distributed.Mesh(None, "points", 0, 3, torch.device("cpu")),
                                      host[:7])


@functools.lru_cache(maxsize=1)
def _scene():
    """B = 4 sequences of 3 frames on test_torch_multiseq's scene, sequence
    b from frame b of the strafe at its ground-truth pose; the frame-0 map
    from the port's extraction."""
    field = CornerField(np.random.default_rng(0), n=500)
    poses = make_trajectory(16, "strafe")
    frames = np.stack([render_frame(field, _CAM, R, t)
                       for R, t in poses[:_ST + B]]).astype(np.float32)
    kps = orb_extract(torch.from_numpy(frames[0]), _OCFG)
    kxy, kval, kdesc = kps.xy.numpy(), kps.valid.numpy(), kps.desc.numpy()
    R0g, t0g = poses[0]
    pc = field.pts @ R0g.T + t0g
    proj = (pc[:, :2] / pc[:, 2:]) * [_CAM.fx, _CAM.fy] + [_CAM.cx, _CAM.cy]
    P = 512
    mp, md, mv = np.zeros((P, 3), np.float32), np.zeros((P, 8), np.int32), np.zeros(P, bool)
    n = 0
    for i in np.where(kval)[0]:
        d = np.linalg.norm(proj - kxy[i], axis=1)
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < P:
            mp[n], md[n], mv[n] = field.pts[j], kdesc[i], True
            n += 1
    assert n > 100
    images = np.stack([frames[b:b + _ST] for b in range(B)])
    R0 = np.stack([poses[b][0] for b in range(B)]).astype(np.float32)
    t0 = np.stack([poses[b][1] for b in range(B)]).astype(np.float32)
    K = np.array([[_CAM.fx, 0, _CAM.cx], [0, _CAM.fy, _CAM.cy], [0, 0, 1]], np.float32)
    tile = lambda x: np.broadcast_to(x, (B,) + x.shape).copy()  # noqa: E731
    return images, tile(mp), tile(md), tile(mv), R0, t0, K


def _dp(group, images, mp, md, mv, R0, t0, K):
    """The step on each sequence's second frame, and the sequence runner."""
    T = torch.from_numpy
    step = multiseq.make_multiseq_step(_OCFG, MatcherConfig(), 640, 480, device="cpu",
                                       group=group)
    run = multiseq.make_multiseq_sequence_runner(_CAM, _OCFG, MatcherConfig(), TrackerConfig(),
                                                 device="cpu", group=group)
    maps = (T(mp), T(md), T(mv), T(R0), T(t0), T(K))
    return step(T(images[:, 1].copy()), *maps), run(T(images), *maps)


def _dp_worker(mesh, args):
    torch.set_num_threads(1)
    return _dp(mesh.group, *args), _foreign()


@functools.lru_cache(maxsize=1)
def _dp_both():
    torch.set_num_threads(1)
    return distributed.spawn(_dp_worker, 2, "gloo", "cpu", (_scene(),), timeout=300), \
        _dp(None, *_scene())


def test_dp_step_across_ranks_equals_one_process():
    ranks, (ref, _) = _dp_both()
    assert int(ref.n_matches.min()) > 50
    for (step, _), foreign in ranks:
        assert not foreign
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(step, f), getattr(ref, f).numpy(), f)


def test_dp_sequence_runner_across_ranks_equals_one_process():
    ranks, (_, ref) = _dp_both()
    assert ref["R"].shape == (B, _ST, 3, 3)
    for (_, run), _ in ranks:
        assert set(run) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(run[k], ref[k].numpy(), k)


def test_dp_batch_must_divide_the_ranks():
    """B = 3 over 2 ranks raises on every rank, before any collective."""
    images, mp, md, mv, R0, t0, K = _scene()
    args = tuple(a[:3] for a in (images, mp, md, mv, R0, t0)) + (K,)
    with pytest.raises(RuntimeError, match="do not divide"):
        distributed.spawn(_dp_worker, 2, "gloo", "cpu", (args,), timeout=300)


def test_dryrun_multichip_completes():
    """The counterpart of ``__graft_entry__.dryrun_multichip`` on 2 gloo
    CPU ranks: every mode runs (the init and mapping runners across the
    ranks too), and the replicated and gathered results agree."""
    ranks = dryrun_multichip(2, "gloo", "cpu")
    assert len(ranks) == 2
    for r in ranks:
        assert r["dp_n_kps"].shape == (2,) and r["tp_matches"].shape == (16,)
        assert r["pp_R"].shape == (3, 3, 3) and np.isfinite(r["pp_R"]).all()
        assert np.isfinite(r["ba_cost"])
        assert r["init_state"].shape == (2, 3) and r["init_R"].shape == (2, 3, 3, 3)
        assert np.isin(r["init_state"], (0, 1, 2)).all() and np.isfinite(r["init_R"]).all()
        assert r["map_R"].shape == (2, 2, 3, 3) and np.isfinite(r["map_R"]).all()
        assert r["map_n_kps"].shape == r["map_inserted_kf"].shape == (2, 2)
        assert r["map_inserted_kf"].dtype == bool and r["map_pt_valid"].shape == (2, 16)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[0][k], ranks[1][k], k)


def _failing_worker(mesh):
    if mesh.rank == 1:
        raise KeyError("rank one fails")
    torch.distributed.barrier()    # rank 0 waits in a collective for rank 1
    return mesh.rank


def test_spawn_reports_a_failing_rank():
    """A rank's exception comes back with its traceback, and the rank left
    waiting in a collective is stopped."""
    with pytest.raises(RuntimeError, match="rank one fails"):
        distributed.spawn(_failing_worker, 2, "gloo", "cpu", timeout=120)


def _aborted_first_worker(mesh):
    """Rank 1 tears the group down under rank 0's barrier and fails a
    second later, so rank 0's abort is the first report the parent gets."""
    if mesh.rank == 1:
        torch.distributed.destroy_process_group()
        time.sleep(1.0)
        raise KeyError("rank one fails")
    torch.distributed.barrier()
    return mesh.rank


def test_spawn_names_the_root_cause_when_the_abort_arrives_first():
    """The rank whose collective was torn down reports first; ``spawn``
    still waits for the failing rank's report and puts it first, with the
    aborted rank's traceback after it."""
    with pytest.raises(RuntimeError, match="rank one fails") as err:
        distributed.spawn(_aborted_first_worker, 2, "gloo", "cpu", timeout=120)
    msg = str(err.value)
    assert msg.startswith("rank 1 failed:"), msg[:200]
    assert "rank 0 failed (a collective torn down by a failing peer)" in msg


def _tag_worker(mesh, tag):
    t = torch.tensor([tag], dtype=torch.int64)
    torch.distributed.all_reduce(t)
    return int(t) // mesh.size


def test_spawns_at_once_keep_their_own_groups():
    """Four ``spawn`` calls at once, as parallel test workers make them:
    each group forms on its own store, and each all-reduce sums its own
    ranks' tags only."""
    got, errors = {}, []

    def one(tag):
        try:
            got[tag] = distributed.spawn(_tag_worker, 2, "gloo", "cpu", (tag,), timeout=120)
        except Exception as e:  # raised in the test thread below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(tag,)) for tag in (3, 5, 7, 11)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=180)
        assert not th.is_alive()
    assert not errors, errors
    assert got == {tag: [tag, tag] for tag in (3, 5, 7, 11)}


def test_spawn_env_is_local(monkeypatch):
    """``spawn`` sets ``LOCAL_RANK`` in its ranks only."""
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    assert distributed.spawn(_local_rank_worker, 2, "gloo", "cpu", timeout=120) == ["0", "1"]
    assert "LOCAL_RANK" not in os.environ


def _local_rank_worker(mesh):
    return os.environ["LOCAL_RANK"]
