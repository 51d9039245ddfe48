"""Parity of the port's map, bundle adjustment, matchers and PnP with the
JAX package, on the CPU: the same seeded numpy inputs go through the JAX
function and the port's counterpart (its plain kernel versions, since the
tensors lie on the CPU), and each tolerance states its reason."""

import contextlib
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.geometry import fundamental as jx_fundamental
from orb_slam_tracking_tpu.geometry.pnp import ransac_pnp as jx_ransac_pnp
from orb_slam_tracking_tpu.ops import matcher as jx_matcher
from orb_slam_tracking_tpu.optim.ba import BAResult as JxBAResult
from orb_slam_tracking_tpu.optim.ba import bundle_adjust as jx_bundle_adjust
from orb_slam_tracking_tpu.optim.lm import inv3x3 as jx_inv3x3
from orb_slam_tracking_tpu.slam import map as jx_map
from orb_slam_tracking_tpu.slam import tracker as jx_tracker
from orb_slam_tracking_tpu.utils import metrics as jx_metrics
from orb_slam_tracking_tpu.utils.synthetic import synthetic_ba_problem as jx_synthetic_ba
from orb_slam_tracking_tpu_torch import entry as port_entry
from orb_slam_tracking_tpu_torch.config import MatcherConfig, TrackerConfig
from orb_slam_tracking_tpu_torch.convert import slam_map_from_numpy, slam_map_to_numpy
from orb_slam_tracking_tpu_torch.geometry.fundamental import fundamental_from_poses
from orb_slam_tracking_tpu_torch.geometry.pnp import ransac_pnp
from orb_slam_tracking_tpu_torch.ops import hamming
from orb_slam_tracking_tpu_torch.ops.matcher import match_descriptors, search_for_triangulation
from orb_slam_tracking_tpu_torch.optim import ba as ba_module
from orb_slam_tracking_tpu_torch.optim.ba import BAResult, bundle_adjust, lm_solver
from orb_slam_tracking_tpu_torch.optim.lm import inv3x3
from orb_slam_tracking_tpu_torch.slam import map as slam_map
from orb_slam_tracking_tpu_torch.slam import tracker
from orb_slam_tracking_tpu_torch.utils import metrics
from orb_slam_tracking_tpu_torch.utils.synthetic import synthetic_ba_problem
from test_ba import _ba_problem
from test_torch_init import _triangulation_tol

K = np.array([[450.0, 0, 320], [0, 450, 240], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True)
def _one_thread():
    """These tensors are small: one intra-op thread is as fast alone, and
    under xdist it keeps this file's worker from spinning against the
    others (the lockstep tests ran ~50x slower with six workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


# --- copies -----------------------------------------------------------------

@pytest.mark.parametrize("with_scale", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_equal_jax(seed, with_scale):
    """umeyama_alignment and ate_rmse are numpy in both packages: equal."""
    rng = np.random.default_rng(seed)
    src = rng.standard_normal((40, 3))
    dst = 1.7 * src @ np.linalg.qr(rng.standard_normal((3, 3)))[0].T + 0.3 \
        + rng.normal(0, 0.01, src.shape)
    for got, ref in zip(metrics.umeyama_alignment(src, dst, with_scale),
                        jx_metrics.umeyama_alignment(src, dst, with_scale)):
        np.testing.assert_array_equal(got, ref)
    assert metrics.ate_rmse(src, dst, with_scale) == jx_metrics.ate_rmse(src, dst, with_scale)


@pytest.mark.parametrize("seed,nK,nP", [(7, 8, 256), (3, 5, 100)])
def test_synthetic_ba_problem_equals_jax(seed, nK, nP):
    """Same draws; the pose perturbation exp(xi) goes through each package's
    f32 se3_exp (|xi| ~ 0.03: Rodrigues terms of size <= 1, a few roundings
    each, so the perturbed poses agree to 1e-6); everything else equal."""
    got = synthetic_ba_problem(seed, nK, nP)
    ref = jx_synthetic_ba(seed, nK, nP)
    for i in (0, 3, 4, 5, 6):
        np.testing.assert_array_equal(got[i], ref[i])
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-6)


def _poses(rng, n):
    out = []
    for _ in range(n):
        w = rng.normal(0, 0.2, 3)
        th = np.linalg.norm(w)
        k = w / th
        Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
        out.append(((np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32),
                    rng.normal(0, 1, 3).astype(np.float32)))
    return out


def test_fundamental_from_poses(rng):
    """F21 = K^-T [t21]x R21 K^-1: a few f32 products of entries <= 1e3 in
    each package, compared relative to the largest entry (8 roundings of
    the chained products: 8u ~ 5e-7, bounded at 1e-5 for the inverse)."""
    (R1, t1), (R2, t2) = _poses(rng, 2)
    ref = np.asarray(jx_fundamental.fundamental_from_poses(R1, t1, R2, t2, K))
    got = fundamental_from_poses(_t(R1), _t(t1), _t(R2), _t(t2), _t(K)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    # batched over the poses
    got_b = fundamental_from_poses(_t(np.stack([R1, R2])), _t(np.stack([t1, t2])),
                                   _t(R2), _t(t2), _t(K)).numpy()
    np.testing.assert_allclose(got_b[0], ref, rtol=0, atol=1e-5 * np.abs(ref).max())
    assert np.abs(got_b[1]).max() < 1e-6 * np.abs(ref).max()  # t21 = 0: F = 0


def test_inv3x3_matches_jax(rng):
    """The adjugate formula evaluated in the same order in both: equal
    to the last bit or one ulp of the quotient (2 ulps allowed)."""
    M = rng.standard_normal((64, 3, 3)).astype(np.float32)
    M = M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(3, dtype=np.float32)
    M[0] = 0  # the determinant guard
    ref = np.asarray(jx_inv3x3(jnp.asarray(M)))
    got = inv3x3(_t(M)).numpy()
    np.testing.assert_array_max_ulp(got, ref, maxulp=2)


# --- map operations ---------------------------------------------------------

_P, _KC, _N = 256, 6, 128


def _random_map(rng):
    """Every SlamMap field at P 256, Kc 6, N 128 (O = 6 x 512), random."""
    O = _KC * jx_map.OBS_PER_KF
    normal = rng.normal(size=(_P, 3))
    rot = _poses(rng, _KC)
    m = dict(
        pts=rng.normal(0, 2, (_P, 3)) + [0, 0, 6],
        desc=rng.integers(0, 2**32, (_P, 8), dtype=np.uint32),
        pt_valid=rng.random(_P) < 0.6, n_obs=rng.integers(0, 6, _P),
        pt_birth_kf=rng.integers(0, 5, _P), pt_visible=rng.integers(0, 12, _P),
        pt_found=rng.integers(0, 12, _P),
        pt_normal=normal / np.linalg.norm(normal, axis=1, keepdims=True),
        pt_dmin=rng.uniform(0.5, 1, _P), pt_dmax=rng.uniform(2, 8, _P),
        kf_R=np.stack([R for R, _ in rot]), kf_t=np.stack([t for _, t in rot]),
        kf_valid=rng.random(_KC) < 0.85, kf_frame_id=rng.permutation(40)[:_KC],
        kf_kp_xy=rng.uniform(0, 600, (_KC, _N, 2)),
        kf_kp_desc=rng.integers(0, 2**32, (_KC, _N, 8), dtype=np.uint32),
        kf_kp_octave=rng.integers(0, 8, (_KC, _N)),
        kf_kp_angle=rng.uniform(0, 360, (_KC, _N)),
        kf_kp_valid=rng.random((_KC, _N)) < 0.9,
        kf_kp_pt=rng.integers(-1, _P, (_KC, _N)),
        obs_kf=rng.integers(0, _KC, O), obs_pt=rng.integers(0, _P, O),
        obs_kp=rng.integers(0, _N, O), obs_uv=rng.uniform(0, 600, (O, 2)),
        obs_inv_sigma2=rng.uniform(0.2, 1, O), obs_valid=rng.random(O) < 0.6,
    )
    dtypes = {"desc": np.uint32, "kf_kp_desc": np.uint32}
    empty = slam_map_to_numpy(slam_map.empty_map(
        TrackerConfig(max_map_points=_P, max_keyframes=_KC), _N))
    return {k: np.asarray(v, dtypes.get(k, empty[k].dtype)) for k, v in m.items()}


def _both(fields):
    return (jx_map.SlamMap(**{k: jnp.asarray(v) for k, v in fields.items()}),
            slam_map_from_numpy(fields, device="cpu"))


def _assert_maps_equal(jx, port, float_tol=None):
    """Integer and bool fields equal; float fields equal, or within
    ``float_tol`` {field: (rtol, atol)}."""
    got = slam_map_to_numpy(port)
    for f in jx_map.SlamMap._fields:
        ref = np.asarray(getattr(jx, f))
        assert got[f].dtype == ref.dtype and got[f].shape == ref.shape, f
        if float_tol and f in float_tol:
            np.testing.assert_allclose(got[f], ref, *float_tol[f], err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], ref, err_msg=f)


def test_empty_map_and_free_slots_equal_jax():
    cfg = TrackerConfig(max_map_points=_P, max_keyframes=_KC)
    jx = jx_map.empty_map(jx_config.TrackerConfig(max_map_points=_P, max_keyframes=_KC), _N)
    _assert_maps_equal(jx, slam_map.empty_map(cfg, _N))
    valid = np.random.default_rng(1).random(50) < 0.5
    for n in (0, 3, 50):
        np.testing.assert_array_equal(slam_map.free_slots(torch.tensor(valid), n),
                                      jx_map.free_slots(valid, n))


def _lanes(rng, n, cap, pool):
    """``n`` real lanes on distinct indices of ``pool``, then padding lanes
    up to ``cap`` that carry real (taken) indices and must be dropped."""
    idx = rng.choice(pool, size=cap, replace=False)
    idx[n:] = idx[rng.integers(0, n, cap - n)]
    return idx.astype(np.int32), np.arange(cap) < n


@pytest.mark.parametrize("add_stats", [0, 1])
def test_scatter_obs_equals_jax(rng, add_stats):
    fields = _random_map(rng)
    jx, port = _both(fields)
    free_rows = np.where(~fields["obs_valid"])[0]
    rows, ok = _lanes(rng, 40, 64, free_rows)
    kp, _ = _lanes(rng, 40, 64, np.arange(_N))
    tgt = rng.integers(0, _P, 64).astype(np.int32)
    uv = rng.uniform(0, 600, (64, 2)).astype(np.float32)
    inv = rng.uniform(0.2, 1, 64).astype(np.float32)
    ref = jx_tracker._scatter_obs(jx, 2, *map(jnp.asarray, (rows, tgt, kp, uv, inv, ok)),
                                  add_stats)
    got = tracker.scatter_obs(port, 2, *map(_t, (rows, tgt, kp, uv, inv, ok)), add_stats)
    _assert_maps_equal(ref, got)


def test_scatter_new_points_equals_jax(rng):
    fields = _random_map(rng)
    jx, port = _both(fields)
    n, cap = 30, 64
    pslots, ok = _lanes(rng, n, cap, np.where(~fields["pt_valid"])[0])
    free_rows = np.where(~fields["obs_valid"])[0]
    rows = rng.choice(free_rows, 2 * cap, replace=False).astype(np.int32)
    rows1, rows2 = rows[:cap], rows[cap:]
    rows1[n:], rows2[n:] = rows1[0], rows2[0]  # padding lanes on taken rows
    kp1, _ = _lanes(rng, n, cap, np.arange(_N))
    kp2, _ = _lanes(rng, n, cap, np.arange(_N))
    kp2[n:] = _N + 5  # out of range: must be dropped, not clamped into a row
    args = (pslots, rows1, rows2, kp1, kp2,
            rng.normal(0, 2, (cap, 3)).astype(np.float32),
            rng.uniform(0, 600, (cap, 2)).astype(np.float32),
            rng.uniform(0, 600, (cap, 2)).astype(np.float32),
            rng.uniform(0.2, 1, cap).astype(np.float32),
            rng.uniform(0.2, 1, cap).astype(np.float32),
            np.full(cap, 7, np.int32), ok)
    ref = jx_tracker._scatter_new_points(jx, 4, 1, *map(jnp.asarray, args))
    got = tracker.scatter_new_points(port, 4, 1, *map(_t, args))
    _assert_maps_equal(ref, got)


def test_write_and_remove_kf_equal_jax(rng):
    fields = _random_map(rng)
    jx, port = _both(fields)
    n = 100  # fewer keypoints than the snapshot capacity: padded
    snap = (rng.integers(0, 2**32, (n, 8), dtype=np.uint32), rng.integers(0, 8, n).astype(np.int32),
            rng.uniform(0, 360, n).astype(np.float32), rng.random(n) < 0.9,
            rng.uniform(0, 600, (n, 2)).astype(np.float32),
            rng.integers(-1, _P, n).astype(np.int32))
    R, t = _poses(rng, 1)[0]
    ref = jx_tracker._jit_write_kf(jx, 3, *map(jnp.asarray, snap), jnp.asarray(R),
                                   jnp.asarray(t), 17)
    got = tracker.write_kf(port, 3, _t(snap[0].view(np.int32)), *map(_t, snap[1:]), _t(R),
                           _t(t), 17)
    _assert_maps_equal(ref, got)
    _assert_maps_equal(jx_tracker._jit_remove_kf(ref, 3), tracker.remove_kf(got, 3))
    _assert_maps_equal(jx_tracker._jit_remove_kf(jx, 0), tracker.remove_kf(port, 0))


def test_update_normal_and_depth_equals_jax(rng):
    """Integer and bool fields equal. The normal sums up to ~20 unit
    vectors per point in another order and renormalises: each coordinate
    within (20 + 10) u ~ 2e-6, bounded at 1e-5. dmax is a max of
    dist * 1.2^octave, one norm and one power per candidate in each
    package (a few ulps): rtol 1e-6; dmin divides it by a power of 1.2."""
    fields = _random_map(rng)
    jx, port = _both(fields)
    ref = jx_map.update_normal_and_depth(jx, 1.2, 8)
    got = slam_map.update_normal_and_depth(port, 1.2, 8)
    _assert_maps_equal(ref, got, {"pt_normal": (0, 1e-5), "pt_dmax": (1e-6, 0),
                                  "pt_dmin": (1e-6, 0)})


def test_apply_ba_result_equals_jax(rng):
    fields = _random_map(rng)
    jx, port = _both(fields)
    inlier = rng.random(fields["obs_valid"].shape[0]) < 0.7
    R, t, X = fields["kf_R"] * 0.5, fields["kf_t"] + 1, fields["pts"] - 1
    ref = jx_map.apply_ba_result(jx, JxBAResult(
        kf_R=jnp.asarray(R), kf_t=jnp.asarray(t), pts=jnp.asarray(X), cost0=jnp.float32(0),
        cost=jnp.float32(0), obs_inlier=jnp.asarray(inlier)))
    got = slam_map.apply_ba_result(port, BAResult(
        kf_R=_t(R), kf_t=_t(t), pts=_t(X), cost0=torch.tensor(0.0), cost=torch.tensor(0.0),
        obs_inlier=_t(inlier)))
    _assert_maps_equal(ref, got)


def _two_views(rng, n=60):
    """A well-conditioned pair: points 4-8 deep, a 0.6 baseline."""
    pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                    rng.uniform(4, 8, n)], -1).astype(np.float32)
    (R1, t1), (R2, t2) = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32)), \
        (np.eye(3, dtype=np.float32), np.array([-0.6, 0.05, 0.02], np.float32))

    def proj(R, t):
        pc = pts @ R.T + t
        return ((pc[:, :2] / pc[:, 2:]) * 450 + [320, 240]).astype(np.float32)

    return pts, (R1, t1), (R2, t2), proj(R1, t1) + rng.normal(0, 0.5, (n, 2)).astype(
        np.float32), proj(R2, t2) + rng.normal(0, 0.5, (n, 2)).astype(np.float32)


def test_triangulate_world_equals_jax(rng):
    """Each point within the first-order bound of test_torch_init's
    triangulation test (derived in float64 from the same f32 inputs)."""
    _, (R1, t1), (R2, t2), x1, x2 = _two_views(rng)
    ref = np.asarray(jx_tracker._triangulate_world(R1, t1, R2, t2, K, x1, x2))
    got = tracker.triangulate_world(*map(_t, (R1, t1, R2, t2, K, x1, x2))).numpy()
    P1 = K @ np.concatenate([R1, t1[:, None]], 1)
    P2 = K @ np.concatenate([R2, t2[:, None]], 1)
    tol = _triangulation_tol(P1, P2, x1, x2)
    assert (np.linalg.norm(got - ref, axis=-1) <= tol).all()


# --- matchers ---------------------------------------------------------------

def _keyframes(rng, n_kf=4, m=300, vetting=False):
    """Keyframes' keypoints over one set of points: each sees half of them
    with their descriptor (bits flipped at random) and the rest of its
    keypoints are distractors; the last keyframe is the current one, the
    others its neighbours, placed along a 0.3-per-step strafe. With
    ``vetting`` a sixth of the points lie 300x deeper (too little
    parallax), and the current keyframe sees a sixth of its points
    shifted 20-80 px along the strafe (off in depth, some behind a
    camera) and a sixth 3-6.5 px across it at octave 7 (inside the
    epipolar gate, some outside the neighbours' reprojection chi2).
    -> sides
    (desc, xy, octave, angle, valid), each neighbour's F21 to the current
    one, and the poses."""
    n = 200
    pts = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n),
                    rng.uniform(4, 9, n)], -1).astype(np.float32)
    if vetting:
        pts[: n // 6] *= 300
    base = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    poses = []
    for k in range(n_kf):
        yaw = np.radians(2.0 * k)
        R = np.array([[np.cos(yaw), 0, np.sin(yaw)], [0, 1, 0],
                      [-np.sin(yaw), 0, np.cos(yaw)]], np.float32).T
        poses.append((R, (-R @ np.array([-0.3 * k, 0.02 * k, 0.05 * k])).astype(np.float32)))
    sides = []
    for k, (R, t) in enumerate(poses):
        pc = pts @ R.T + t
        xy = (pc[:, :2] / pc[:, 2:]) * 450 + [320, 240]
        h = n // 6
        if vetting and k == n_kf - 1:
            xy[h:2 * h, 0] += rng.choice([-1, 1], h) * rng.uniform(20, 80, h)
            xy[2 * h:3 * h, 1] += rng.choice([-1, 1], h) * rng.uniform(3.0, 6.5, h)
        take = rng.permutation(n)[: m // 2]
        flips = np.uint32(1) << rng.integers(0, 32, (len(take), 8)).astype(np.uint32)
        desc = np.concatenate([base[take] ^ np.where(rng.random((len(take), 8)) < 0.3, flips, 0),
                               rng.integers(0, 2**32, (m - len(take), 8), dtype=np.uint32)])
        xy = np.concatenate([xy[take] + rng.normal(0, 0.7, (len(take), 2)),
                             rng.uniform(0, 640, (m - len(take), 2))]).astype(np.float32)
        angle = np.concatenate([rng.uniform(0, 10, len(take)),
                                rng.uniform(0, 360, m - len(take))]).astype(np.float32)
        octave = rng.integers(0, 4, m).astype(np.int32)
        if vetting and k == n_kf - 1:
            octave[: len(take)][(take >= 2 * h) & (take < 3 * h)] = 7
        sides.append((desc.astype(np.uint32), xy, octave, angle, rng.random(m) < 0.95))
    Rc, tc = poses[-1]
    F = [np.asarray(jx_fundamental.fundamental_from_poses(R, t, Rc, tc, K)) for R, t in poses[:-1]]
    return sides, F, poses


@pytest.mark.parametrize("check_orientation", [True, False])
@pytest.mark.parametrize("seed", [0, 1])
def test_search_for_triangulation_exact(seed, check_orientation):
    """Integer outputs equal, one neighbour at a time (B = 1) and with the
    neighbours' rows stacked (B = 3, each neighbour against the same
    current keyframe)."""
    rng = np.random.default_rng(seed)
    cfg = MatcherConfig(check_orientation=check_orientation)
    jcfg = jx_config.MatcherConfig(**dataclasses.asdict(cfg))
    sides, Fs, _ = _keyframes(rng)
    cur = sides[-1]

    def port_side(s):
        return (_t(s[0].view(np.int32)),) + tuple(map(_t, s[1:]))

    refs = []
    for one, F in zip(sides, Fs):
        ref = jx_matcher.search_for_triangulation(*map(jnp.asarray, one), *map(jnp.asarray, cur),
                                                  jnp.asarray(F), jcfg, 1.2)
        assert int(ref.n_matches) > 20
        refs.append(ref)
        got = search_for_triangulation(*(x[None] for x in port_side(one)), *port_side(cur),
                                       _t(F)[None], cfg, 1.2)
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f)[0].numpy(), np.asarray(getattr(ref, f)),
                                          f)
    stacked = [torch.stack([port_side(s)[i] for s in sides[:-1]]) for i in range(5)]
    before = hamming.hamming_matrix.launches
    got = search_for_triangulation(*stacked, *port_side(cur), _t(np.stack(Fs)), cfg, 1.2)
    assert hamming.hamming_matrix.launches == before  # CPU: the plain version
    for b, ref in enumerate(refs):
        for f in ref._fields:
            np.testing.assert_array_equal(getattr(got, f)[b].numpy(),
                                          np.asarray(getattr(ref, f)), f)


@pytest.mark.parametrize("seed", [0, 1])
def test_covis_match_triangulate_equals_jax(seed):
    """The keyframe insert's batched match-and-triangulate over three
    neighbours (``_keyframes`` with ``vetting``): matches and the vetting
    mask equal, and each matched point within test_torch_init's derived
    triangulation bound. The scene makes every vetting test reject some
    rows: cheirality alone, parallax, and the reprojection chi2."""
    rng = np.random.default_rng(seed)
    cfg = MatcherConfig()
    jcfg = jx_config.MatcherConfig(**dataclasses.asdict(cfg))
    sides, _, poses = _keyframes(rng, vetting=True)
    nb = [np.stack([s[i] for s in sides[:-1]]) for i in range(5)]
    cur = sides[-1]
    R_nb = np.stack([R for R, _ in poses[:-1]])
    t_nb = np.stack([t for _, t in poses[:-1]])
    Rc, tc = poses[-1]
    m12, pts, ok = map(np.asarray, jx_tracker._covis_match_triangulate(
        *map(jnp.asarray, nb), *map(jnp.asarray, cur), jnp.asarray(R_nb), jnp.asarray(t_nb),
        jnp.asarray(Rc), jnp.asarray(tc), jnp.asarray(K), mcfg=jcfg, scale_factor=1.2))
    got = tracker.covis_match_triangulate(
        _t(nb[0].view(np.int32)), *map(_t, nb[1:]), _t(cur[0].view(np.int32)),
        *map(_t, cur[1:]), *map(_t, (R_nb, t_nb, Rc, tc, K)), cfg, 1.2)
    np.testing.assert_array_equal(got[0].numpy(), m12)
    np.testing.assert_array_equal(got[2].numpy(), ok)
    P2 = K @ np.concatenate([Rc, tc[:, None]], 1)
    kinds = np.zeros(3, int)
    for b in range(3):
        has = m12[b] >= 0
        P1 = K @ np.concatenate([R_nb[b], t_nb[b][:, None]], 1)
        tol = _triangulation_tol(P1, P2, nb[1][b][has], cur[1][m12[b][has]])
        d = np.linalg.norm(got[1].numpy()[b][has] - pts[b][has], axis=-1)
        assert (d <= tol).all()
        p, rej = pts[b][has], ~ok[b][has]
        behind = ((p @ R_nb[b].T + t_nb[b])[:, 2] <= 0.05) | ((p @ Rc.T + tc)[:, 2] <= 0.05)
        r1, r2 = p + R_nb[b].T @ t_nb[b], p + Rc.T @ tc
        flat = (r1 * r2).sum(-1) >= 0.9998 * np.linalg.norm(r1, axis=-1) * np.linalg.norm(r2, axis=-1)
        kinds += [(rej & behind & ~flat).sum(), (rej & flat).sum(), (rej & ~behind & ~flat).sum()]
    assert (kinds > 0).all(), kinds


@pytest.mark.parametrize("ratio,th", [(0.7, 50), (0.9, 100), (0.75, 256)])
def test_match_descriptors_exact(rng, ratio, th):
    """matches12 equal to JAX's over the full matrix; rows and columns
    with invalid keypoints, and repeated columns (ties for best and second)."""
    pool = rng.integers(0, 2**32, (240, 8), dtype=np.uint32)
    d1 = pool[rng.integers(0, 240, 300)] ^ (np.uint32(1) << rng.integers(0, 32, (300, 8)).astype(
        np.uint32)) * (rng.random((300, 8)) < 0.2)
    d2 = pool[np.concatenate([rng.permutation(240)[:200], rng.integers(0, 240, 50)])]
    v1, v2 = rng.random(300) < 0.9, rng.random(250) < 0.9
    ref = np.asarray(jx_matcher.match_descriptors(jnp.asarray(d1), jnp.asarray(v1),
                                                  jnp.asarray(d2), jnp.asarray(v2), ratio, th))
    got = match_descriptors(_t(d1.view(np.int32)), _t(v1), _t(d2.view(np.int32)), _t(v2),
                            ratio=ratio, th=th).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref >= 0).sum() > 10


# --- PnP --------------------------------------------------------------------

@pytest.mark.parametrize("outliers", [0.0, 0.4])
def test_ransac_pnp_with_jax_draws(outliers):
    """JAX's own uniforms handed to the port. The hypotheses are 6-point
    DLT null vectors of 12x12 systems that the two packages' f32 eigen
    solvers resolve differently within their conditioning, so the winner
    is held to what the data fix: ok and the inlier count within 2 (a
    refit on a set that differs by a borderline match), the pose to 2e-3
    (~0.1 deg, a ~0.5 px noise on 150+ inliers), and the inlier sets
    agreeing but for those borderline matches."""
    rng = np.random.default_rng(3)
    M, n = 512, 300
    pts = np.zeros((M, 3), np.float32)
    uv = np.zeros((M, 2), np.float32)
    valid = np.zeros(M, bool)
    P = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 9, n)], -1)
    (R, t), = _poses(rng, 1)
    t = t * 0.2
    pc = P @ R.T + t
    obs = (pc[:, :2] / pc[:, 2:]) * 450 + [320, 240] + rng.normal(0, 0.5, (n, 2))
    n_out = int(outliers * n)
    obs[:n_out] = rng.uniform(0, 640, (n_out, 2))
    pts[:n], uv[:n], valid[:n] = P, obs, True
    key = jax.random.PRNGKey(11)
    ref = jx_ransac_pnp(jnp.asarray(pts), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K),
                        key, iterations=1024)
    u = np.asarray(jax.random.uniform(key, (1024, 6)))
    got = ransac_pnp(_t(pts), _t(uv), _t(valid), _t(K), _t(u))
    assert bool(got.ok) and bool(ref.ok)
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=2e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=2e-3 * np.linalg.norm(t) + 1e-3)
    assert (got.inliers.numpy() != np.asarray(ref.inliers)).sum() <= 4
    assert np.abs(got.R.numpy() - R).max() < 5e-3  # and both near the truth


# --- bundle adjustment --------------------------------------------------------

def _jx_ba(args, **kw):
    return jx_bundle_adjust(*map(jnp.asarray, args), segment_mode="scatter", **kw)


def _port_ba(args, **kw):
    return bundle_adjust(*map(_t, args), **kw)


def _ba_args(rng, **kw):
    _, _, _, pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv = _ba_problem(rng, **kw)
    nK, nP, O = kf_R0.shape[0], pts0.shape[0], len(obs_kf)
    fixed = np.zeros(nK, bool)
    fixed[0] = True
    return [kf_R0, kf_t0, pts0, obs_kf, obs_pt, obs_uv, np.ones(O, np.float32),
            np.ones(O, bool), fixed, np.ones(nP, bool), K]


def _assert_ba_close(got, ref, rel_cost=1e-4, pose_tol=2e-4, pt_tol=2e-3):
    """Both are the same f32 LM on the same problem; they differ in the
    order of the segment sums and contractions (relative ~1e-6 in the
    normal equations), which the reduced camera system's conditioning
    amplifies in each step, and in which near-converged steps they accept.
    Held at the converged optimum: the cost to ``rel_cost``, rotation and
    translation entries to ``pose_tol``, points (4-9 deep) to ``pt_tol``,
    and the inlier classification equal.

    These are not derived: a componentwise first-order bound on the f32
    Schur step (formation of U, V, W and V^-1, the Schur sum, Cholesky's
    backward error) bounds nothing on these problems, whose one fixed
    camera leaves the scale free. They are set from the
    readings of every case that calls this (converges, fixed, invalid,
    window 6/7/3, gate, skip) under the default MKL dispatch and
    MKL_CBWR=COMPATIBLE, AVX2 and AVX512 on one x86 CPU, with one torch
    thread and with eight: largest cost0 gap 2.4e-7 (bound 1e-5), cost
    2.2e-6 (1e-4), rotation 3.1e-6 (2e-4), translation 2.0e-5 (2e-4),
    points 7.0e-5 (2e-3), inliers equal; so each bound is 10x to 45x
    above the worst reading."""
    assert float(got.cost0) == pytest.approx(float(ref.cost0), rel=1e-5)
    assert float(got.cost) == pytest.approx(float(ref.cost), rel=rel_cost)
    np.testing.assert_allclose(got.kf_R.numpy(), np.asarray(ref.kf_R), atol=pose_tol)
    np.testing.assert_allclose(got.kf_t.numpy(), np.asarray(ref.kf_t), atol=pose_tol)
    np.testing.assert_allclose(got.pts.numpy(), np.asarray(ref.pts), atol=pt_tol)
    np.testing.assert_array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))


@pytest.mark.parametrize("case", ["converges", "fixed", "invalid"])
def test_bundle_adjust_matches_jax(rng, case):
    """tests/test_ba.py's problems: ground-truth convergence (15 steps),
    three fixed cameras (5), and invalid observations and points (8)."""
    args = _ba_args(rng)
    iters = 15
    if case == "fixed":
        args[8][:3] = True
        iters = 5
    if case == "invalid":
        args[7][:50] = False
        args[5][:50] += 300
        args[9][::13] = False
        iters = 8
    ref, got = _jx_ba(args, iterations=iters), _port_ba(args, iterations=iters)
    _assert_ba_close(got, ref)
    if case == "fixed":
        np.testing.assert_array_equal(got.kf_R.numpy()[:3], args[0][:3])
        np.testing.assert_array_equal(got.kf_t.numpy()[:3], args[1][:3])


@pytest.mark.parametrize("max_free", [6, 7, 3])
def test_bundle_adjust_window_matches_jax(max_free):
    """test_ba.py:122,159: the compact free-camera window at the free count
    (6), above it (7), and below it (3: the overflow cameras are demoted
    to fixed and stay exactly where they were)."""
    nK, nP = 8, 256
    pts0, kf_R0, kf_t0, obs_kf, obs_pt, obs_uv, K7 = synthetic_ba_problem(7, nK, nP)
    O = nK * nP
    fixed = np.zeros(nK, bool)
    fixed[0] = True
    if max_free != 3:
        fixed[3] = True
    args = [kf_R0, kf_t0, pts0, obs_kf, obs_pt, obs_uv, np.ones(O, np.float32),
            np.ones(O, bool), fixed, np.ones(nP, bool), K7]
    iters = 6 if max_free == 3 else 8
    ref = _jx_ba(args, iterations=iters, max_free_cams=max_free)
    got = _port_ba(args, iterations=iters, max_free_cams=max_free)
    _assert_ba_close(got, ref)
    if max_free == 3:
        np.testing.assert_array_equal(got.kf_R.numpy()[4:], kf_R0[4:])
        np.testing.assert_array_equal(got.kf_t.numpy()[4:], kf_t0[4:])


def _midsolve_args(seed):
    """test_ba.py:239's problem: 28-degree starts with 20 % gross outliers."""
    rng = np.random.default_rng(seed)
    args = _ba_args(rng, noise_px=1.0, depth_noise=0.2, pose_noise=0.3)
    n_out = int(len(args[5]) * 0.2)
    idx = rng.choice(len(args[5]), n_out, replace=False)
    args[5] = args[5].copy()
    args[5][idx] += rng.uniform(-250, 250, (n_out, 2)).astype(np.float32)
    return args


def _jx_stepper(args, rel):
    """JAX's scatter BA one LM step at a time: its first carry and its
    scanned step, taken from the scan of an un-jitted call."""
    seen = {}
    scan = jax.lax.scan

    def spy(f, init, xs=None, length=None, **kw):
        seen["f"], seen["init"] = f, init
        return scan(f, init, xs, length=length, **kw)

    with mock.patch.object(jax.lax, "scan", spy):
        jx_bundle_adjust.__wrapped__(*map(jnp.asarray, args), iterations=1,
                                     early_stop_rel=rel, segment_mode="scatter")
    return seen["init"], jax.jit(lambda c: seen["f"](c, None)[0])


def _port_ensemble(args, rel, n_orders, seed=100):
    """Admissible evaluations of the port's LM step: the exact one (float64)
    and f32 ones with the observations and the points in ``n_orders``
    random orders besides their own (every segment sum and contraction
    then adds in another order, which is how two f32 implementations of
    one step differ), each once as the port forms the point blocks'
    inverses (in float64, rounded to f32) and once with JAX's f32
    adjugate, which its fused multiply-adds leave between the two. ->
    [step(carry as numpy) -> carry as numpy]; the second is the port's
    own step."""
    rng = np.random.default_rng(seed)
    nP, O = len(args[2]), len(args[3])
    f64 = [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]
    orders = [(np.arange(O), np.arange(nP))] * 2
    orders += [(rng.permutation(O), rng.permutation(nP)) for _ in range(n_orders)]
    steps = []
    for f32_inverse in (False, True):
        for m, (po, pq) in enumerate(orders):
            if m == 0 and f32_inverse:
                continue
            a = list(f64 if m == 0 else args)
            back = np.argsort(pq)
            a[2], a[9] = a[2][pq], a[9][pq]
            a[3], a[4] = a[3][po], back[a[4][po]].astype(np.int32)
            a[5], a[6], a[7] = a[5][po], a[6][po], a[7][po]
            _, step, _ = lm_solver(*map(_t, a), early_stop_rel=rel)

            def run(c, step=step, pq=pq, back=back, dt=a[2].dtype, f32_inverse=f32_inverse):
                c = [torch.tensor(x.astype(dt) if x.dtype == np.float32 else x) for x in c]
                c[2] = c[2][pq]
                with contextlib.ExitStack() as stack:
                    if f32_inverse:
                        stack.enter_context(mock.patch.object(
                            ba_module, "inv3x3", lambda M: inv3x3(M.to(torch.float32))))
                    out = [x.numpy() for x in step(tuple(c))]
                out[2] = out[2][back]
                return out
            steps.append(run)
    return steps


def _lockstep(args, rel, iters, edit=None, n_orders=4):
    """Steps JAX's BA and the port's ensemble from one shared carry, JAX's
    own iterate (``edit`` may rewrite it first), for ``iters`` steps. A
    step is determined when every evaluation of the ensemble takes the
    same decisions (accept, done, the reject count); there JAX must take
    them too, with the same nu, and on a rejection keep the carry bit for
    bit with the same damping (lam*nu of one carry). An accepted step's
    state is not compared here: from these carries JAX's f32 cost can lie
    several spreads outside the ensemble's (seed 2's sixth step: ~1400
    from the exact step, where the port's orders lie within ~180), so no
    tolerance follows from the arithmetic; the well-conditioned cases
    hold the states. -> decisions of the determined steps that start
    unconverged."""
    carry, jstep = _jx_stepper(args, rel)
    ens = _port_ensemble(args, rel, n_orders)
    seen = []
    for _ in range(iters):
        c = [np.asarray(x) for x in carry]
        if edit is not None:
            c = edit(c)
            carry = tuple(jnp.asarray(x) for x in c)
        outs = [run(c) for run in ens]
        carry = jstep(carry)
        j = [np.asarray(x) for x in carry]
        key = lambda o: (bool(o[5] < c[5]), bool(o[6]), int(o[7]))
        if len({key(o) for o in outs}) > 1 or c[6]:
            continue  # undetermined, or the no-op step after the gate
        assert key(j) == key(outs[1]), (key(j), key(outs[1]))
        assert float(j[4]) == float(outs[1][4])  # nu
        if not key(j)[0]:
            for i in (0, 1, 2, 5):
                np.testing.assert_array_equal(j[i], c[i])
            assert float(j[3]) == float(outs[1][3])
        seen.append(key(j))
    return seen


def _assert_second_step_factors(args):
    """Seed 0's second step from JAX's iterate, where an f32 adjugate V^-1
    leaves the port's Schur system not positive definite (every order of
    the ensemble fails to factor there) while JAX's factors: the port's own
    step factors (``cholesky_ex``'s info 0) and takes JAX's decision."""
    carry, jstep = _jx_stepper(args, 1e-4)
    carry = jstep(carry)
    c = [np.asarray(x) for x in carry]
    j = [np.asarray(x) for x in jstep(carry)]
    infos = []
    factor = torch.linalg.cholesky_ex

    def spy(A, **kw):
        L, info = factor(A, **kw)
        infos.append(int(info))
        return L, info

    _, own, adjugate = _port_ensemble(args, 1e-4, 0)
    with mock.patch.object(torch.linalg, "cholesky_ex", spy):
        adjugate(c)
        out = own(c)
    assert infos[0] != 0 and infos[1] == 0, infos
    key = lambda o: (bool(o[5] < c[5]), bool(o[6]), int(o[7]))
    assert key(out) == key(j) == (True, False, 0)
    assert np.isfinite(out[5]) and float(out[5]) < float(c[5])


@pytest.mark.parametrize("case", ["gate", "skip", "midsolve0", "midsolve2"])
def test_bundle_adjust_gate_matches_jax(rng, case):
    """test_ba.py:192,217,239: the early-stop gate at 1e-4 beside JAX's,
    the gate's later steps as no-ops (15 and 50 steps give identical
    results in the port), and the gate through mid-solve rejections on
    28-degree starts with 20 % gross outliers. Where the gate fires on a
    step whose gain is at the f32 noise of the cost, the two packages may
    stop one step apart, so there the cost is held to 1e-3 and the poses
    to 2e-3 (the gate's threshold is 1e-4 or 1e-3 of the cost).

    The mid-solve problems have a free scale (one fixed camera) and
    near-singular point blocks, so their steps are not fixed by f32
    arithmetic: from one carry the exact step, JAX's and the port's can
    take different decisions (seed 0's second step: the port's f32 Schur
    system is not positive definite where the exact one is; seed 2's
    sixth: both f32 steps accept what the exact one rejects), and whole
    solves end far apart. So both packages are stepped from JAX's iterate
    (``_lockstep``) and held to the same decisions on every step that all
    admissible evaluations decide alike; and the gated solves to the JAX
    test's own criterion (within 5 % of the ungated one)."""
    if case.startswith("midsolve"):
        args = _midsolve_args(int(case[-1]))
        iters = 13
        ref = _jx_ba(args, iterations=iters, early_stop_rel=1e-4)
        got = _port_ba(args, iterations=iters, early_stop_rel=1e-4)
        ungated = _port_ba(args, iterations=iters)
        assert float(got.cost) <= float(ungated.cost) * 1.05 + 1e-3
        assert float(ref.cost) <= float(_jx_ba(args, iterations=iters).cost) * 1.05 + 1e-3
        assert float(got.cost) < 0.8 * float(got.cost0)
        seen = _lockstep(args, 1e-4, iters)
        assert len(seen) >= 8
        assert any(s[0] for s in seen) and any(not s[0] and s[2] > 0 for s in seen)
        if case == "midsolve0":
            _assert_second_step_factors(args)
        return
    args = _ba_args(rng)
    iters, rel = 15, (1e-4 if case == "gate" else 1e-3)
    ref = _jx_ba(args, iterations=iters, early_stop_rel=rel)
    got = _port_ba(args, iterations=iters, early_stop_rel=rel)
    _assert_ba_close(got, ref, rel_cost=1e-3, pose_tol=2e-3, pt_tol=2e-2)
    if case == "skip":
        longer = _port_ba(args, iterations=50, early_stop_rel=rel)
        assert float(got.cost) == float(longer.cost)
        assert torch.equal(got.kf_R, longer.kf_R) and torch.equal(got.pts, longer.pts)


@pytest.mark.parametrize("branch,value,ends", [
    ("pred", 0.0225, None), ("rejects", 8, False), ("rejects", 9, True),
    ("nu", 1.5, False), ("nu", 2.0, True)])
def test_bundle_adjust_gate_branches_match_jax(branch, value, ends):
    """The gate's ways out of a rejected step, on either side of each
    threshold, from carries shared by both packages on the two mid-solve
    problems (each step starts unconverged). "pred": early_stop_rel
    0.0225, between the predicted gains of seed 0's rejected steps (2.7 %
    of the cost in the exact step) and of seed 2's (1.75-1.78 %), so some
    determined rejections end the solve and some do not. "rejects": the
    carry's count set to 8 or 9, so a rejection is the ninth or the tenth
    in a row. "nu": the damping set to 6e7 and nu to 1.5 or 2, so a
    rejection's lam*nu stays under or passes 1e8 (so damped, a step moves
    the cost by less than f32 resolves, and seed 2's are rejected in every
    evaluation; the count is set to 0). For the last two early_stop_rel is
    1e-12, under any gain f32 resolves, so no other way out is open. Decided as in
    ``_lockstep``; there must be determined rejections."""
    edit, rel = (lambda c: c[:6] + [np.asarray(False), c[7]]), 1e-12
    if branch == "pred":
        rel = value
    elif branch == "rejects":
        edit = lambda c: c[:6] + [np.asarray(False), np.asarray(value, np.int32)]
    else:
        edit = lambda c: (c[:3] + [np.asarray(6e7, np.float32), np.asarray(value, np.float32)]
                          + [c[5], np.asarray(False), np.asarray(0, np.int32)])
    rejected = [s for seed in (0, 2) for s in _lockstep(_midsolve_args(seed), rel, 13, edit=edit)
                if not s[0]]
    assert {s[1] for s in rejected} == ({True, False} if ends is None else {ends}), rejected


def test_bundle_adjust_rejects_tpu_formulations():
    """The port has the scatter formulation only: a tracker configured
    for a TPU one is refused, and bundle_adjust takes no mode."""
    cfg = dataclasses.replace(port_entry.TRACKER_CONFIG, tracker=dataclasses.replace(
        port_entry.TRACKER_CONFIG.tracker, ba_segment_mode="cammajor"))
    with pytest.raises(ValueError, match="scatter"):
        tracker.Tracker(cfg, device="cpu")
    args = _ba_args(np.random.default_rng(0), nK=3, nP=20)
    with pytest.raises(TypeError):
        _port_ba(args, segment_mode="scatter")
