"""The port's multi-sequence batch axis (``parallel/multiseq.py`` and the
``[B]`` forms of what its step runs) against the JAX package's ``vmap``,
on the CPU.

Every batched input holds B *distinct* sequences (other images, maps and
poses per row), so that a batch-stride fault cannot hide behind identical
copies. Each batched function is held twice: exactly against the port's
own single-sequence call on each row (the batch axis must not change a
bit), and against ``jax.vmap`` of the JAX function to the tolerance the
single-sequence parity tests state for it. The kernels' plain versions
run here (CPU tensors); the card holds the kernels to them
(``chip_smoke.py`` ``[multiseq]``).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.ops import fast as jx_fast
from orb_slam_tracking_tpu.ops.extractor import orb_extract as jx_orb_extract
from orb_slam_tracking_tpu.ops.proj_matcher import search_by_projection as jx_sbp
from orb_slam_tracking_tpu.ops.pyramid import reflect_pad as jx_reflect_pad
from orb_slam_tracking_tpu.optim import lm as jx_lm
from orb_slam_tracking_tpu.optim.pose_opt import optimize_pose as jx_optimize_pose
from orb_slam_tracking_tpu.parallel import multiseq as jx_multiseq
from orb_slam_tracking_tpu_torch.config import (CameraConfig, MatcherConfig, OrbConfig,
                                                TrackerConfig)
from orb_slam_tracking_tpu_torch.geometry import se3
from orb_slam_tracking_tpu_torch.ops import atlas, describe, fast, hamming
from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract
from orb_slam_tracking_tpu_torch.ops.proj_matcher import search_by_projection
from orb_slam_tracking_tpu_torch.optim import lm
from orb_slam_tracking_tpu_torch.optim.pose_opt import optimize_pose
from orb_slam_tracking_tpu_torch.parallel import multiseq
from orb_slam_tracking_tpu_torch.types import Keypoints
from orb_slam_tracking_tpu_torch.utils.synthetic import CornerField, make_trajectory, render_frame
from test_torch_hamming_fused import _inputs, _numpy_gated_min

B = 3
_CFG = OrbConfig(n_features=300, n_levels=4)
_H, _W = 240, 320
_CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, width=_W, height=_H)
_K = np.array([[_CAM.fx, 0, _CAM.cx], [0, _CAM.fy, _CAM.cy], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the plain FAST takes its banded form, and the
    xdist workers do not spin against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jx(cfg):
    """The JAX package's config with the port's fields."""
    names = {f.name for f in dataclasses.fields(getattr(jx_config, type(cfg).__name__))}
    return getattr(jx_config, type(cfg).__name__)(
        **{k: v for k, v in dataclasses.asdict(cfg).items() if k in names})


@functools.lru_cache(maxsize=1)
def _images():
    """B distinct rendered frames: three corner fields, three poses."""
    poses = make_trajectory(16, "strafe")
    return np.stack([
        render_frame(CornerField(np.random.default_rng(7 + b), n=500), _CAM, *poses[3 * b])
        for b in range(B)]).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _extracted():
    """The port's batched and per-image extractions and JAX's vmap."""
    imgs = _images()
    consts = ExtractorConstants(_H, _W, _CFG, device="cpu")
    batched = orb_extract(torch.from_numpy(imgs), _CFG, consts)
    single = [orb_extract(torch.from_numpy(im), _CFG, consts) for im in imgs]
    ref = jax.jit(jax.vmap(lambda im: jx_orb_extract(im, _jx(_CFG))))(jnp.asarray(imgs))
    return batched, single, {f: np.asarray(getattr(ref, f)) for f in ref._fields}


# --- the closed-form solve ------------------------------------------------------------

def _spd_systems(rng, n):
    """Damped normal equations of random pose Jacobians: SPD, as the LM's."""
    J = rng.normal(size=(n, 40, 6)).astype(np.float32)
    H = np.einsum("bki,bkj->bij", J, J).astype(np.float32)
    return H, rng.normal(size=(n, 6)).astype(np.float32)


def _solve_tol(H, b):
    """A first-order f32 bound per system: cond(M) * |x| * 64 eps (the
    Schur form's dozen dependent products and sums, each within an ulp,
    amplified at most by the condition number)."""
    x = np.linalg.solve(H.astype(np.float64), b.astype(np.float64)[..., None])[..., 0]
    cond = np.linalg.cond(H.astype(np.float64))
    return x, cond[:, None] * np.abs(x).max(-1, keepdims=True) * 64 * np.finfo(np.float32).eps


def test_solve_spd6_matches_jax(rng):
    H, b = _spd_systems(rng, 16)
    x64, tol = _solve_tol(H, b)
    got = lm.solve_spd6(torch.from_numpy(H), torch.from_numpy(b)).numpy()
    ref = np.asarray(jx_lm.solve_spd6(jnp.asarray(H), jnp.asarray(b)))
    assert (np.abs(got - x64) <= tol).all() and (np.abs(ref - x64) <= tol).all()
    assert (np.abs(got - ref) <= 2 * tol).all()


@pytest.mark.parametrize("batched", [True, False])
def test_solve_damped_batched_matches_jax(rng, batched):
    """``batched=True`` takes the closed form, as JAX's: within the f32
    bound of the float64 solution and of JAX's, and equal to ``solve_spd6``
    of the damped systems. ``batched=False`` keeps pivoted LU over the same
    [B, 6, 6] systems, equal to ``torch.linalg.solve`` of each."""
    H, b = _spd_systems(rng, 8)
    lam = rng.uniform(1e-4, 1e-1, 8).astype(np.float32)
    Hd = H + lam[:, None, None] * np.einsum("bii->bi", H)[:, None, :] * np.eye(6, dtype=np.float32)
    x64, tol = _solve_tol(Hd, b)
    got = lm.solve_damped(torch.from_numpy(H), torch.from_numpy(b), torch.from_numpy(lam),
                          batched=batched).numpy()
    ref = np.asarray(jax.vmap(lambda h, v, l: jx_lm.solve_damped(h, v, l, batched=True))(
        jnp.asarray(H), jnp.asarray(b), jnp.asarray(lam)))
    assert (np.abs(got - x64) <= tol).all()
    assert (np.abs(got - ref) <= 2 * tol).all()
    if batched:
        want = lm.solve_spd6(torch.from_numpy(Hd), torch.from_numpy(b))
    else:
        want = torch.stack([torch.linalg.solve(torch.from_numpy(Hd[i]), torch.from_numpy(b[i]))
                            for i in range(len(H))])
    np.testing.assert_array_equal(got, want.numpy())


# --- the batched pose LM --------------------------------------------------------------

def _pose_problems(rng):
    """B distinct pose problems: 300 points, 1-px noise, 10 % gross
    outliers, a random start 3 degrees / 0.1 off."""
    N = 300
    pts = (rng.uniform(-2, 2, (B, N, 3)) + [0, 0, 6]).astype(np.float32)
    w_true = rng.normal(0, 0.03, (B, 3)).astype(np.float32)
    R = se3.so3_exp(torch.from_numpy(w_true)).numpy()
    t = rng.normal(0, 0.2, (B, 3)).astype(np.float32)
    pc = np.einsum("bij,bnj->bni", R, pts) + t[:, None]
    uv = (pc[..., :2] / pc[..., 2:] * [_CAM.fx, _CAM.fy] + [_CAM.cx, _CAM.cy]
          + rng.normal(0, 1, (B, N, 2))).astype(np.float32)
    uv[:, :30] += rng.uniform(20, 60, (B, 30, 2)).astype(np.float32)
    inv_s2 = (1.0 / 1.2 ** (2.0 * rng.integers(0, 4, (B, N)))).astype(np.float32)
    valid = rng.random((B, N)) < 0.95
    R0 = se3.so3_exp(torch.from_numpy(w_true + rng.normal(0, 0.05, (B, 3)).astype(np.float32))).numpy()
    t0 = (t + rng.normal(0, 0.1, (B, 3))).astype(np.float32)
    return R0, t0, pts, uv, inv_s2, valid


def test_optimize_pose_batched_matches_vmap(rng):
    """B poses at once against ``jax.vmap`` of JAX's ``optimize_pose(...,
    batched_solve=True)``: the same inliers, poses within 2e-4 and
    translations within 1e-3 (test_torch_track's single-pose bounds), and
    each row within 1e-5 of the port's own call on it (the batched
    products reduce over the observations in another order; readings
    ~1e-7)."""
    args = _pose_problems(rng)
    got = optimize_pose(*map(torch.from_numpy, args), torch.from_numpy(_K), batched_solve=True)
    ref = jax.jit(jax.vmap(lambda *a: jx_optimize_pose(*a, jnp.asarray(_K), batched_solve=True)))(
        *map(jnp.asarray, args))
    np.testing.assert_array_equal(got.inlier.numpy(), np.asarray(ref.inlier))
    np.testing.assert_array_equal(got.n_inliers.numpy(), np.asarray(ref.n_inliers))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3, rtol=0)
    for b in range(B):
        one = optimize_pose(*(torch.from_numpy(a[b]) for a in args), torch.from_numpy(_K),
                            batched_solve=True)
        assert torch.equal(one.inlier, got.inlier[b])
        np.testing.assert_allclose(one.R.numpy(), got.R[b].numpy(), atol=1e-5, rtol=0)
        np.testing.assert_allclose(one.t.numpy(), got.t[b].numpy(), atol=1e-5, rtol=0)


# --- the batched extraction and its kernels' plain versions ---------------------------

def test_batched_extraction_equals_single_and_vmap():
    batched, single, ref = _extracted()
    for b in range(B):
        for f in Keypoints._fields:
            assert torch.equal(getattr(batched, f)[b], getattr(single[b], f)), (b, f)
    # JAX's vmap, to test_torch_extract's bounds: the port resizes with the
    # f64-derived matrices, JAX on the CPU with f32 weights, which moves
    # upper-level scores by ~3e-3, so two keypoints of a level whose
    # scores lie closer than that may trade places in the level's order
    # (readings: one such pair, at level 3, 7e-4 apart); the sets per
    # level are equal and every keypoint keeps its descriptor
    np.testing.assert_array_equal(batched.valid.numpy(), ref["valid"])
    np.testing.assert_array_equal(batched.octave.numpy(), ref["octave"])
    np.testing.assert_allclose(batched.response.numpy(), ref["response"], atol=1e-2, rtol=0)
    for b in range(B):
        def rows(xy, desc, valid, octave):
            return [sorted((tuple(p), tuple(d)) for p, d, v, o in
                           zip(xy.tolist(), desc.tolist(), valid, octave) if v and o == lvl)
                    for lvl in range(_CFG.n_levels)]
        assert rows(batched.xy[b].numpy(), batched.desc[b].numpy(), ref["valid"][b],
                    ref["octave"][b]) == rows(ref["xy"][b], ref["desc"][b].view(np.int32),
                                              ref["valid"][b], ref["octave"][b]), b
        moved = (batched.xy[b].numpy() != ref["xy"][b]).any(-1)
        assert moved.sum() <= 4 and (ref["octave"][b][moved] > 0).all(), b
    assert not torch.equal(batched.xy[0], batched.xy[1])  # distinct rows


def test_fast_score_batched_plain(rng):
    """B1's plain version over [B, Hp, Wp]: each canvas exactly its single
    call and JAX's FAST score (exact: selects and one subtraction)."""
    padded = np.stack([np.asarray(jx_reflect_pad(jnp.asarray(im), 19)) for im in _images()])
    got = fast.fast_score(torch.from_numpy(padded), 19)
    assert got.shape == (B, _H, _W)
    for b in range(B):
        np.testing.assert_array_equal(got[b].numpy(),
                                      fast.fast_score(torch.from_numpy(padded[b]), 19).numpy())
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jx_fast.fast_score(jnp.asarray(padded[b]), 19)))
    assert fast.fast_score.launches == 0


def test_orient_describe_batched_plain(rng):
    """B4f's plain version over B canvases of B x N keypoints (distinct
    positions per row): each row exactly its single call."""
    imgs = torch.from_numpy(_images())
    consts = ExtractorConstants(_H, _W, _CFG, device="cpu")
    lay = atlas.atlas_layout(_H, _W, _CFG)
    canvas = atlas.build_atlas(imgs, lay, consts.resize_mats)
    blurred = atlas.gaussian_blur(canvas, consts.gauss)
    N = 200
    xy = torch.from_numpy(np.stack([rng.integers(0, _W, (B, N)), rng.integers(0, _H, (B, N))],
                                   -1).astype(np.float32))
    yc = xy[..., 1].to(torch.int32) + 19
    xc = xy[..., 0].to(torch.int32) + 19
    ang, desc = describe.orient_describe(canvas, blurred, yc, xc, xy, consts.pattern_xy,
                                         consts.umax)
    assert ang.shape == (B, N) and desc.shape == (B, N, 8)
    for b in range(B):
        a1, d1 = describe.orient_describe(canvas[b], blurred[b], yc[b], xc[b], xy[b],
                                          consts.pattern_xy, consts.umax)
        assert torch.equal(ang[b], a1) and torch.equal(desc[b], d1)
    assert not torch.equal(desc[0], desc[1])
    assert describe.orient_describe.launches == 0


def test_hamming_gated_min_batched_plain(rng):
    """B3f's plain version over [B, P, 8] x [B, N, 8] with [B, ...] gates:
    each problem exactly its single call and the numpy loop over JAX's
    XOR + popcount distances."""
    probs = [_inputs(rng, 64, 48, kind) for kind in ("random", "ties", "empty")]
    args = [torch.from_numpy(np.stack([p[i] for p in probs])) for i in range(12)]
    got = hamming.hamming_gated_min(*args)
    for b, p in enumerate(probs):
        one = hamming.hamming_gated_min(*(torch.from_numpy(np.ascontiguousarray(a)) for a in p))
        want = _numpy_gated_min(*p)
        for g, o, w in zip(got, one, want):
            assert torch.equal(g[b], o)
            np.testing.assert_array_equal(g[b].numpy(), w)
    assert hamming.hamming_gated_min.launches == 0


@functools.lru_cache(maxsize=1)
def _second_frames():
    """Each sequence's next frame: its field from the strafe's next pose."""
    poses = make_trajectory(16, "strafe")
    return np.stack([
        render_frame(CornerField(np.random.default_rng(7 + b), n=500), _CAM, *poses[3 * b + 2])
        for b in range(B)]).astype(np.float32)


def test_search_for_initialization_batched():
    """B initialization pairs matched at once (one Hamming launch on the
    card) and compacted: each row exactly its single call, and JAX's vmap
    exactly (test_torch_init holds one pair's matches to JAX's exactly)."""
    from orb_slam_tracking_tpu.ops import matcher as jx_matcher
    from orb_slam_tracking_tpu_torch.ops.matcher import compact_matches, search_for_initialization

    k1, _, _ = _extracted()
    k2 = orb_extract(torch.from_numpy(_second_frames()), _CFG,
                     ExtractorConstants(_H, _W, _CFG, device="cpu"))
    args = (k1.desc, k1.xy, k1.octave, k1.angle_deg, k1.valid,
            k2.desc, k2.xy, k2.octave, k2.angle_deg, k2.valid)
    got = search_for_initialization(*args, MatcherConfig())
    pairs, pv = compact_matches(got.matches12, 256)
    assert int(got.n_matches.min()) > 10  # octave-0 matches of 300 features
    for b in range(B):
        one = search_for_initialization(*(a[b] for a in args), MatcherConfig())
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(got, f)[b]), (b, f)
        p1, v1 = compact_matches(one.matches12, 256)
        assert torch.equal(p1, pairs[b]) and torch.equal(v1, pv[b])
    J = [jnp.asarray(a.numpy().view(np.uint32) if a.dtype == torch.int32 and a.dim() == 3
                     else a.numpy()) for a in args]
    ref = jax.jit(jax.vmap(lambda *a: jx_matcher.search_for_initialization(
        *a, jx_config.MatcherConfig())))(*J)
    np.testing.assert_array_equal(got.matches12.numpy(), np.asarray(ref.matches12))
    np.testing.assert_array_equal(got.n_matches.numpy(), np.asarray(ref.n_matches))
    jp, jv = jax.vmap(lambda m: jx_matcher.compact_matches(m, 256))(ref.matches12)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(pv.numpy(), np.asarray(jv))


def _maps(rng, kps):
    """B distinct 256-point maps in front of each row's camera, half of
    their descriptors the row's keypoints' (so that matches exist), half
    with viewing statistics."""
    P = 256
    u = rng.uniform(10, _W - 10, (B, P))
    v = rng.uniform(10, _H - 10, (B, P))
    z = rng.uniform(3.0, 8.0, (B, P))
    pts = np.stack([(u - _CAM.cx) / _CAM.fx * z, (v - _CAM.cy) / _CAM.fy * z, z], -1)
    desc = rng.integers(0, 2**32, (B, P, 8), dtype=np.uint32).view(np.int32)
    kd = kps.desc.numpy()
    for b in range(B):
        take = rng.choice(np.where(kps.valid[b].numpy())[0], P // 2, replace=False)
        desc[b, : P // 2] = kd[b, take]
        xy = kps.xy[b, take].numpy()
        pts[b, : P // 2] = np.stack([(xy[:, 0] - _CAM.cx) / _CAM.fx * z[b, :P // 2],
                                     (xy[:, 1] - _CAM.cy) / _CAM.fy * z[b, :P // 2],
                                     z[b, :P // 2]], -1)
    has = rng.random((B, P)) < 0.5
    dist = np.linalg.norm(pts, axis=-1)
    normal = pts / dist[..., None]
    dmax = np.where(has, dist * 1.2 ** rng.integers(0, 4, (B, P)), 0.0)
    dmin = np.where(has, dmax / 1.2 ** 3, 0.0)
    return [a.astype(np.float32) for a in (pts, normal, dmin, dmax)] + [
        desc, rng.random((B, P)) < 0.9]


def test_search_by_projection_batched(rng):
    """B sequences' projection matches (per-row map, pose, keypoints; K
    shared): each row exactly its single call, and JAX's vmap exactly
    (integer keys and the same f32 projection)."""
    batched, _, _ = _extracted()
    pts, normal, dmin, dmax, desc, valid = _maps(rng, batched)
    R = se3.so3_exp(torch.from_numpy(rng.normal(0, 0.01, (B, 3)).astype(np.float32))).numpy()
    t = rng.normal(0, 0.02, (B, 3)).astype(np.float32)
    T = torch.from_numpy
    kw = dict(kp_octave=batched.octave, scale_factor=_CFG.scale_factor, n_levels=_CFG.n_levels)
    got = search_by_projection(T(pts), T(desc), T(valid), T(R), T(t), T(_K), batched.desc,
                               batched.xy, batched.valid, 15.0, MatcherConfig(), _W, _H,
                               pt_normal=T(normal), pt_dmin=T(dmin), pt_dmax=T(dmax), **kw)
    assert int(got.n_matches.min()) > 20
    for b in range(B):
        one = search_by_projection(
            T(pts[b]), T(desc[b]), T(valid[b]), T(R[b]), T(t[b]), T(_K), batched.desc[b],
            batched.xy[b], batched.valid[b], 15.0, MatcherConfig(), _W, _H,
            pt_normal=T(normal[b]), pt_dmin=T(dmin[b]), pt_dmax=T(dmax[b]),
            kp_octave=batched.octave[b], scale_factor=_CFG.scale_factor, n_levels=_CFG.n_levels)
        for f in one._fields:
            assert torch.equal(getattr(one, f), getattr(got, f)[b]), (b, f)

    def jx_one(*a):
        return jx_sbp(*a[:6], a[6], a[7], a[8], 15.0, jx_config.MatcherConfig(), _W, _H,
                      kp_octave=a[9], scale_factor=_CFG.scale_factor, pt_normal=a[10],
                      pt_dmin=a[11], pt_dmax=a[12], n_levels=_CFG.n_levels)

    J = jnp.asarray
    ref = jax.jit(jax.vmap(jx_one, in_axes=(0, 0, 0, 0, 0, None) + (0,) * 7))(
        J(pts), J(desc.view(np.uint32)), J(valid), J(R), J(t), J(_K),
        J(batched.desc.numpy().view(np.uint32)), J(batched.xy.numpy()),
        J(batched.valid.numpy()), J(batched.octave.numpy()), J(normal), J(dmin), J(dmax))
    for f in ("kp_for_point", "point_for_kp", "n_matches", "n_visible", "visible"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)


# --- the runners ----------------------------------------------------------------------

_SCAM = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0, width=640, height=480)
_SOCFG = OrbConfig(n_features=300)
_ST = 3  # frames per sequence


@functools.lru_cache(maxsize=1)
def _scene():
    """tests/test_parallel.py's scene (the 500-point field, the 16-pose
    strafe, the frame-0 map associated to ground truth within 3 px), cut
    to 3 frames a sequence; sequence b starts at frame b of the strafe,
    from its ground-truth pose (B distinct sequences on one frozen map)."""
    field = CornerField(np.random.default_rng(0), n=500)
    poses = make_trajectory(16, "strafe")
    frames = np.stack([render_frame(field, _SCAM, R, t)
                       for R, t in poses[:_ST + B]]).astype(np.float32)
    kps = jx_orb_extract(jnp.asarray(frames[0]), _jx(_SOCFG))
    kxy, kval, kdesc = (np.asarray(kps.xy), np.asarray(kps.valid), np.asarray(kps.desc))
    R0g, t0g = poses[0]
    pc = field.pts @ R0g.T + t0g
    proj = (pc[:, :2] / pc[:, 2:]) * [_SCAM.fx, _SCAM.fy] + [_SCAM.cx, _SCAM.cy]
    P = 512
    mp = np.zeros((P, 3), np.float32)
    md = np.zeros((P, 8), np.uint32)
    mv = np.zeros(P, bool)
    n = 0
    for i in np.where(kval)[0]:
        d = np.linalg.norm(proj - kxy[i], axis=1)
        j = int(np.argmin(d))
        if d[j] < 3.0 and n < P:
            mp[n], md[n], mv[n] = field.pts[j], kdesc[i], True
            n += 1
    assert n > 100

    def tile(x):
        return np.broadcast_to(x, (B,) + x.shape).copy()

    images = np.stack([frames[b:b + _ST] for b in range(B)])
    R0 = np.stack([poses[b][0] for b in range(B)]).astype(np.float32)
    t0 = np.stack([poses[b][1] for b in range(B)]).astype(np.float32)
    K = np.array([[_SCAM.fx, 0, _SCAM.cx], [0, _SCAM.fy, _SCAM.cy], [0, 0, 1]], np.float32)
    return images, tile(mp), tile(md), tile(mv), R0, t0, K, poses


def _port_args(images, mp, md, mv, R0, t0, K):
    return (torch.from_numpy(images), torch.from_numpy(mp), torch.from_numpy(md.view(np.int32)),
            torch.from_numpy(mv), torch.from_numpy(R0), torch.from_numpy(t0),
            torch.from_numpy(K))


def test_multiseq_step_matches_jax():
    """One frame of B sequences: the same matches and inliers as JAX's
    step (its mesh of one CPU device), poses within test_torch_track's
    2e-4 / 1e-3."""
    images, mp, md, mv, R0, t0, K, _ = _scene()
    args = (images[:, 1], mp, md, mv, R0, t0, K)
    step = multiseq.make_multiseq_step(_SOCFG, MatcherConfig(), 640, 480, device="cpu")
    got = step(*_port_args(*args))
    mesh = jx_multiseq.make_dp_mesh(jax.devices()[:1])
    ref = jx_multiseq.make_multiseq_step(mesh, _jx(_SOCFG), jx_config.MatcherConfig(), 640, 480)(
        *map(jnp.asarray, args))
    for f in ("n_inliers", "n_matches", "n_kps"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
    assert int(got.n_matches.min()) > 50
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3, rtol=0)


def test_multiseq_sequence_runner_matches_jax():
    """B distinct sequences of 3 frames on frozen maps: the same match and
    inlier counts as JAX's scanned runner, poses within 2e-4 / 1e-3 and
    the rendered ground truth within tests/test_parallel.py's 1.5 deg /
    0.08; each sequence exactly its own B = 1 run."""
    images, mp, md, mv, R0, t0, K, poses = _scene()
    run = multiseq.make_multiseq_sequence_runner(_SCAM, _SOCFG, MatcherConfig(), TrackerConfig(),
                                                 device="cpu")
    got = run(*_port_args(images, mp, md, mv, R0, t0, K))
    mesh = jx_multiseq.make_dp_mesh(jax.devices()[:1])
    ref = jx_multiseq.make_multiseq_sequence_runner(
        mesh, _jx(_SCAM), _jx(_SOCFG), jx_config.MatcherConfig(), jx_config.TrackerConfig())(
        *map(jnp.asarray, (images, mp, md, mv, R0, t0, K)))
    assert got["R"].shape == (B, _ST, 3, 3)
    for k in ("n_inliers", "n_matches"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]), k)
    np.testing.assert_allclose(got["R"].numpy(), np.asarray(ref["R"]), atol=2e-4, rtol=0)
    np.testing.assert_allclose(got["t"].numpy(), np.asarray(ref["t"]), atol=1e-3, rtol=0)
    for b in range(B):
        for f in range(_ST):
            Rg, tg = poses[b + f]
            R = got["R"][b, f].double().numpy()
            err = np.degrees(np.arccos(np.clip((np.trace(R.T @ Rg) - 1) / 2, -1, 1)))
            assert err < 1.5 and np.linalg.norm(got["t"][b, f].numpy() - tg) < 0.08, (b, f)
        one = run(*_port_args(images[b:b + 1], mp[:1], md[:1], mv[:1], R0[b:b + 1],
                              t0[b:b + 1], K))
        for k in one:
            assert torch.equal(one[k][0], got[k][b]), (b, k)
