"""The port's tensor-parallel matcher (``parallel/matcher_sharded.py``) on
gloo ranks against the JAX package's on a mesh of the same size, on the
CPU.

Each world (1, 2 and 4 ranks) is spawned once, as separate processes in
a gloo group on the loopback interface, and runs every case; the ranks
import nothing of jax (``_tp_worker`` checks). The JAX reference runs in
the pytest process on conftest's virtual CPU devices. The cases are
``tests/test_matcher_sharded.py``'s (its ``_random_world`` at (256,
1024) and (100, 800) queries x map rows, and duplicated map descriptors
for the tie-break), pairs of identical queries (the mutual resolution's
tie-break), a map with every row invalid (no query row has a
valid column) and a map whose first half is invalid while the queries
clone rows of that half. Exact against JAX's ``match_descriptors_tp`` and
the port's own ``match_descriptors``; every rank returns the same
matches. Here the kernel wrappers run their plain versions (CPU tensors);
``chip_smoke.py`` ``[dist]`` holds the card's to them.
"""

import functools
import sys

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.ops.matcher import match_descriptors
from orb_slam_tracking_tpu_torch.parallel import distributed
from orb_slam_tracking_tpu_torch.parallel.matcher_sharded import match_descriptors_tp

WORLDS = (1, 2, 4)
CASES = ("random_256_1024", "random_100_800", "ties", "dup_queries", "map_all_invalid",
         "invalid_half_map")
# JAX's int32 key bound: the first capacity past it that divides every world
OVER_CAPACITY = 65536


@functools.lru_cache(maxsize=None)
def _cases():
    """Every case's (desc_q [N, 8] int32, valid_q, desc_m [P, 8] int32,
    valid_m), made from seeds with numpy."""
    from test_matcher_sharded import _random_world

    out = {}
    for name, seed, nq, nm in (("random_256_1024", 11, 256, 1024),
                               ("random_100_800", 11, 100, 800)):
        out[name] = _random_world(np.random.default_rng(seed), nq, nm)
    rng = np.random.default_rng(3)
    dm = np.tile(rng.integers(0, 2 ** 32, (64, 8), dtype=np.uint64).astype(np.uint32), (8, 1))
    out["ties"] = (dm[::16].copy(), np.ones(32, bool), dm, np.ones(512, bool))
    # two identical queries on each of 64 distinct map rows, one in each
    # half of the table: the mutual resolution keeps the lower query index
    dm = rng.integers(0, 2 ** 32, (512, 8), dtype=np.uint64).astype(np.uint32)
    rows = np.concatenate([np.arange(0, 32), np.arange(256, 288)])
    out["dup_queries"] = (np.concatenate([dm[rows], dm[rows]]), np.ones(128, bool), dm,
                          np.ones(512, bool))
    dq, vq, dm, _ = _random_world(np.random.default_rng(5), 128, 512)
    out["map_all_invalid"] = (dq, vq, dm, np.zeros(512, bool))
    dq, vq, dm, vm = _random_world(np.random.default_rng(6), 128, 512)
    vm[:256] = False
    dq[:40] = dm[:40]           # exact hits on invalid rows: must not match there
    out["invalid_half_map"] = (dq, vq, dm, vm)
    return {k: tuple(a.view(np.int32) if a.dtype == np.uint32 else a for a in v)
            for k, v in out.items()}


def _tp_worker(mesh, cases):
    """One rank: every case through ``match_descriptors_tp`` with the
    rank's slice of the map; and whether an over-capacity map raises."""
    torch.set_num_threads(1)
    out = {}
    for name, (dq, vq, dm, vm) in cases.items():
        out[name] = match_descriptors_tp(
            distributed.replicate(mesh, dq), distributed.replicate(mesh, vq),
            distributed.make_global_array(mesh, dm), distributed.make_global_array(mesh, vm))
    per = OVER_CAPACITY // mesh.size
    try:
        match_descriptors_tp(torch.zeros((4, 8), dtype=torch.int32), torch.ones(4, dtype=torch.bool),
                             torch.zeros((per, 8), dtype=torch.int32),
                             torch.ones(per, dtype=torch.bool))
        out["over_capacity_raises"] = False
    except ValueError:
        out["over_capacity_raises"] = True
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "orb_slam_tracking_tpu")
                              for m in sys.modules)
    return out


@functools.lru_cache(maxsize=None)
def _port(world):
    return distributed.spawn(_tp_worker, world, "gloo", "cpu", (_cases(),), timeout=300)


@functools.lru_cache(maxsize=None)
def _jax(world, name):
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu.parallel.matcher_sharded import (make_tp_mesh,
                                                                 match_descriptors_tp as jx_tp)

    # the same program under jit, so that it compiles once per shape (called
    # eagerly, its shard_map compiles on every call)
    dq, vq, dm, vm = _cases()[name]
    fn = jax.jit(functools.partial(jx_tp, make_tp_mesh(jax.devices()[:world])))
    return np.asarray(fn(jnp.asarray(dq.view(np.uint32)), jnp.asarray(vq),
                         jnp.asarray(dm.view(np.uint32)), jnp.asarray(vm)))


@pytest.mark.parametrize("name", CASES)
@pytest.mark.parametrize("world", WORLDS)
def test_tp_matches_jax_and_dense_exactly(world, name):
    ranks = _port(world)
    got = ranks[0][name]
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[name], got)
    np.testing.assert_array_equal(got, _jax(world, name))
    dense = match_descriptors(*(torch.from_numpy(a) for a in _cases()[name]))
    np.testing.assert_array_equal(got, dense.numpy())
    if name.startswith("random"):
        assert (got >= 0).sum() > 20       # the clones matched
    if name == "dup_queries":
        np.testing.assert_array_equal(got[:64], np.concatenate(
            [np.arange(0, 32), np.arange(256, 288)]))
        assert (got[64:] == -1).all()
    if name == "map_all_invalid":
        assert (got == -1).all()
    if name == "invalid_half_map":
        assert (got < 256).sum() == (got == -1).sum()   # nothing matched an invalid row
    assert not any(r["jax_imported"] for r in ranks)


@pytest.mark.parametrize("world", WORLDS)
def test_tp_capacity_bound(world):
    """The port refuses the map capacity that JAX's assert refuses
    (65,536 > 65,532 rows: the int32 merge keys)."""
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu.parallel.matcher_sharded import (make_tp_mesh,
                                                                 match_descriptors_tp as jx_tp)

    assert all(r["over_capacity_raises"] for r in _port(world))
    with pytest.raises(AssertionError):
        jx_tp(make_tp_mesh(jax.devices()[:world]), jnp.zeros((4, 8), jnp.uint32),
              jnp.ones(4, bool), jnp.zeros((OVER_CAPACITY, 8), jnp.uint32),
              jnp.ones(OVER_CAPACITY, bool))
