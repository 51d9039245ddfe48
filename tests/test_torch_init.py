"""Parity of the port's two-view initialization with the JAX package, on
the CPU: the initialization matcher, RANSAC sampling, the H/F solvers and
decompositions, triangulation, ``initialize_two_view`` on the JAX
package's own test scenes, and the whole per-pair slice on a rendered
pair. Inputs are made with numpy from a seed and fed identically to both;
the RANSAC uniforms are JAX's own draws, handed to the port. Each
tolerance states its reason."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.geometry import camera as jx_camera
from orb_slam_tracking_tpu.geometry import fundamental as jx_fundamental
from orb_slam_tracking_tpu.geometry import homography as jx_homography
from orb_slam_tracking_tpu.geometry.sampling import sample_distinct as jx_sample_distinct
from orb_slam_tracking_tpu.geometry.triangulate import triangulate_dlt as jx_triangulate
from orb_slam_tracking_tpu.geometry.twoview import initialize_two_view as jx_init
from orb_slam_tracking_tpu.geometry.twoview import TwoViewResult as JxTwoViewResult
from orb_slam_tracking_tpu.ops.extractor import orb_extract as jx_orb_extract
from orb_slam_tracking_tpu.ops.matcher import MatchResult as JxMatchResult
from orb_slam_tracking_tpu.ops.matcher import compact_matches as jx_compact
from orb_slam_tracking_tpu.ops.matcher import search_for_initialization as jx_search
from orb_slam_tracking_tpu_torch.config import (
    CameraConfig,
    InitConfig,
    MatcherConfig,
    OrbConfig,
    SystemConfig,
)
from orb_slam_tracking_tpu_torch.convert import (
    desc_to_int32,
    keypoints_from_numpy,
    keypoints_to_numpy,
)
from orb_slam_tracking_tpu_torch.entry import (
    INIT_FIELD_POINTS,
    INIT_FRAMES,
    INIT_PAIR,
    init_entry,
)
from orb_slam_tracking_tpu_torch.geometry import camera, fundamental, homography
from orb_slam_tracking_tpu_torch.geometry.sampling import sample_distinct
from orb_slam_tracking_tpu_torch.geometry.triangulate import triangulate_dlt
from orb_slam_tracking_tpu_torch.geometry.twoview import TwoViewResult, initialize_two_view
from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants
from orb_slam_tracking_tpu_torch.ops.matcher import (
    MatchResult,
    compact_matches,
    search_for_initialization,
)
from orb_slam_tracking_tpu_torch.ops.pyramid import gauss_taps
from orb_slam_tracking_tpu_torch.slam.two_view_init import TwoViewInitializer
from orb_slam_tracking_tpu_torch.utils.synthetic import (
    CornerField,
    make_trajectory,
    render_frame,
)

K = np.array([[600.0, 0, 376], [0, 600, 240], [0, 0, 1]], np.float32)


def _t(a):
    return torch.tensor(np.asarray(a))


def _jx(cfg):
    """The JAX package's config with the same fields as the port's."""
    return getattr(jx_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def test_result_types_mirror_jax():
    assert MatchResult._fields == JxMatchResult._fields
    assert TwoViewResult._fields == JxTwoViewResult._fields


# --- search_for_initialization (the cases of tests/test_matcher.py) -------

def _rand_desc(rng, n):
    return rng.integers(0, 2**32, (n, 8), dtype=np.uint32)


def _flip_bits(rng, desc, k):
    out = desc.copy()
    for r in range(out.shape[0]):
        for b in rng.choice(256, size=k, replace=False):
            out[r, b // 32] ^= np.uint32(1) << np.uint32(b % 32)
    return out


def _both_match(desc1, xy1, desc2, xy2, ang1=None, ang2=None, octave1=None,
                cfg=MatcherConfig()):
    n1, n2 = desc1.shape[0], desc2.shape[0]
    a1 = np.zeros(n1, np.float32) if ang1 is None else ang1
    a2 = np.zeros(n2, np.float32) if ang2 is None else ang2
    o1 = np.zeros(n1, np.int32) if octave1 is None else octave1
    o2 = np.zeros(n2, np.int32)
    v1, v2 = np.ones(n1, bool), np.ones(n2, bool)
    ref = jx_search(*(jnp.asarray(a) for a in (desc1, xy1, o1, a1, v1,
                                               desc2, xy2, o2, a2, v2)), _jx(cfg))
    got = search_for_initialization(
        _t(desc_to_int32(desc1)), _t(xy1), _t(o1), _t(a1), _t(v1),
        _t(desc_to_int32(desc2)), _t(xy2), _t(o2), _t(a2), _t(v2), cfg)
    for f in MatchResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
        assert getattr(got, f).dtype == torch.int32, f
    return got


def _identity_case(rng):
    n = 64
    d1 = _rand_desc(rng, n)
    d2 = _flip_bits(rng, d1, 10)
    xy = rng.uniform(100, 400, (n, 2)).astype(np.float32)
    perm = rng.permutation(n)
    noisy = xy[perm] + rng.normal(0, 3, (n, 2)).astype(np.float32)
    octave = (rng.random(n) < 0.2).astype(np.int32)  # a fifth off octave 0
    return dict(desc1=d1, xy1=xy, desc2=d2[perm], xy2=noisy, octave1=octave)


def _mutual_case(rng):
    d_target = _rand_desc(rng, 1)
    d1 = np.concatenate([_flip_bits(rng, d_target, 5), _flip_bits(rng, d_target, 15)])
    return dict(desc1=d1, xy1=np.array([[100.0, 100.0], [120.0, 100.0]], np.float32),
                desc2=np.concatenate([d_target, _rand_desc(rng, 1)]),
                xy2=np.array([[110.0, 100.0], [500.0, 400.0]], np.float32))


def _window_case(rng):
    d = _rand_desc(rng, 3)
    return dict(desc1=d, xy1=np.array([[100.0, 100.0]] * 3, np.float32),
                desc2=_flip_bits(rng, d, 3),
                xy2=np.array([[250.0, 100.0], [180.0, 100.0], [100.0, 201.0]], np.float32))


def _orientation_case(rng):
    n = 40
    d1 = _rand_desc(rng, n)
    ang2 = np.full(n, 22.0, np.float32)
    ang2[:3] = 200.0       # 3 wild rotations
    ang2[3:6] = 46.0       # a second bin under the 0.1x gate of the first
    xy = rng.uniform(150, 350, (n, 2)).astype(np.float32)
    return dict(desc1=d1, xy1=xy, desc2=_flip_bits(rng, d1, 5), xy2=xy,
                ang1=np.full(n, 10.0, np.float32), ang2=ang2)


def _ratio_case(rng):
    """Near-duplicate decoys: the ratio test and the distance gate reject."""
    n = 48
    d1 = _rand_desc(rng, n)
    d2 = np.concatenate([_flip_bits(rng, d1, 8), _flip_bits(rng, d1, 9),
                         _flip_bits(rng, d1[:16], 60)])
    xy1 = rng.uniform(100, 400, (n, 2)).astype(np.float32)
    xy2 = np.concatenate([xy1, xy1, xy1[:16]]) + rng.normal(0, 2, (2 * n + 16, 2))
    return dict(desc1=d1, xy1=xy1, desc2=d2, xy2=xy2.astype(np.float32))


@pytest.mark.parametrize("case", [_identity_case, _mutual_case, _window_case,
                                  _orientation_case, _ratio_case])
def test_search_for_initialization_matches_jax(rng, case):
    got = _both_match(**case(rng))
    if case is _mutual_case:
        assert got.matches12.tolist() == [0, -1]
    if case is _window_case:
        assert got.matches12.tolist() == [-1, 1, -1]
    if case is _orientation_case:
        assert (got.matches12[:3] == -1).all() and int(got.n_reject_orientation) == 6


def test_search_without_orientation_check(rng):
    _both_match(**_orientation_case(rng), cfg=MatcherConfig(check_orientation=False))


@pytest.mark.parametrize("cap", [4, 6, 3])
def test_compact_matches_matches_jax(cap):
    m = np.array([-1, 5, -1, 2, 7, -1], np.int32)
    pairs, valid = compact_matches(_t(m), cap)
    rp, rv = jx_compact(jnp.asarray(m), cap)
    np.testing.assert_array_equal(pairs.numpy(), np.asarray(rp))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(rv))
    assert pairs.dtype == torch.int32


# --- sampling, solvers, triangulation --------------------------------------

@pytest.mark.parametrize("n_valid,k", [(8, 8), (9, 8), (150, 8), (2048, 8), (5, 8), (40, 6)])
def test_sample_distinct_matches_jax(n_valid, k):
    key = jax.random.PRNGKey(n_valid)
    iters = 300
    u = np.asarray(jax.random.uniform(key, (iters, k)))
    ref = np.asarray(jx_sample_distinct(key, jnp.int32(n_valid), iters, k))
    got = sample_distinct(_t(u), torch.tensor(n_valid, dtype=torch.int32), k)
    np.testing.assert_array_equal(got.numpy(), ref)
    if n_valid >= k:
        assert all(len(set(row)) == k for row in got.tolist())


def _project(pts, R, t):
    pc = pts @ R.T + t
    return (pc[:, :2] / pc[:, 2:]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]


def _rot_y(deg):
    th = np.radians(deg)
    return np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0],
                     [-np.sin(th), 0, np.cos(th)]], np.float32)


def _scene(rng, n=300, planar=False):
    if planar:
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        np.full(n, 4.0)], -1)
        pts[:, 2] += pts[:, 0] * 0.8
    else:
        pts = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                        rng.uniform(2, 8, n)], -1)
    return pts.astype(np.float32)


def _up_to_scale(a, b):
    """a and b [..., 3, 3] scaled to unit norm, b's sign turned to a's."""
    a = a / np.linalg.norm(a, axis=(-2, -1), keepdims=True)
    b = b / np.linalg.norm(b, axis=(-2, -1), keepdims=True)
    sign = np.sign((a * b).sum(axis=(-2, -1), keepdims=True))
    return a, b * sign


_U = 2.0 ** -24  # unit roundoff of float32


def _normalize64(x, w):
    """``normalize_points`` in float64: (xn, T) with xn = T x."""
    x = x.astype(np.float64)
    wk = np.ones(x.shape[:-1]) if w is None else w.astype(np.float64)
    tot = wk.sum(-1)[..., None, None]
    mean = (x * wk[..., None]).sum(-2, keepdims=True) / tot
    d = x - mean
    s = tot / (np.abs(d) * wk[..., None]).sum(-2, keepdims=True)
    T = np.zeros(x.shape[:-2] + (3, 3))
    T[..., 0, 0], T[..., 1, 1], T[..., 2, 2] = s[..., 0, 0], s[..., 0, 1], 1.0
    T[..., 0, 2] = -mean[..., 0, 0] * s[..., 0, 0]
    T[..., 1, 2] = -mean[..., 0, 1] * s[..., 0, 1]
    return d * s, T


def _output64(f, T1, T2, solver):
    """The unit-norm solver output for the null vector ``f [9]``, in
    float64: rank 2 (F only) and denormalised."""
    N = f.reshape(3, 3)
    if solver == "f":
        U, S, Vt = np.linalg.svd(N)
        return _unit((T2.T @ (U * [S[0], S[1], 0.0]) @ Vt) @ T1)
    return _unit((np.linalg.inv(T2) @ N) @ T1)


def _unit(a):
    return a / np.linalg.norm(a)


def _derived_tol(x1, x2, w, solver):
    """Per-set bound on the max-abs gap between the two packages' unit-norm
    outputs (see test_solvers_match_jax_up_to_scale), with the
    eigen-decomposition, the Jacobian and the normalisation taken in
    float64 from the same f32 points."""
    x1n, T1 = _normalize64(x1, w)
    x2n, T2 = _normalize64(x2, w)
    u, v, up, vp = x1n[..., 0], x1n[..., 1], x2n[..., 0], x2n[..., 1]
    z, o = np.zeros_like(u), np.ones_like(u)
    if solver == "h":
        A = np.concatenate([np.stack([z, z, z, -u, -v, -o, vp * u, vp * v, vp], -1),
                            np.stack([u, v, o, z, z, z, -up * u, -up * v, -up], -1)], -2)
        rows_w = None if w is None else np.concatenate([w, w], -1)
    else:
        A = np.stack([up * u, up * v, up, vp * u, vp * v, vp, u, v, o], -1)
        rows_w = w
    if rows_w is not None:
        A = A * rows_w[..., None]
    n_rows = A.shape[-2]
    lam, V = np.linalg.eigh(np.swapaxes(A, -1, -2) @ A)
    c = n_rows / (1 - n_rows * _U) + 2 * 5 + 9  # γ_N/u (step 1) + 2·5 (2) + 9 (3)
    h = 1e-7  # central-difference step for J
    tol = np.empty(lam.shape[0])
    for b in range(lam.shape[0]):
        f = V[b, :, 0]
        base = _output64(f, T1[b], T2[b], solver)
        s = 0.0
        for k in range(1, 9):
            plus, minus = (_output64(f + sg * h * V[b, :, k], T1[b], T2[b], solver)
                           for sg in (1.0, -1.0))
            plus, minus = (a * np.sign((a * base).sum()) for a in (plus, minus))
            s += np.abs(plus - minus).max() / (2 * h) / (lam[b, k] - lam[b, 0])
        tol[b] = 2 * c * _U * lam[b].sum() * s
    return 1e-4 + tol


@pytest.mark.parametrize("solver", ["h", "f"])
@pytest.mark.parametrize("weighted", [False, True])
def test_solvers_match_jax_up_to_scale(rng, solver, weighted):
    """Batched 8-point sets and a weighted refit over all points, compared
    up to scale and sign against a bound derived for any BLAS/LAPACK build
    (``_derived_tol``). Each package takes the least eigenvector f of
    M = AᵀA formed in f32 (u = 2⁻²⁴; A has N rows):

    1. forming M errs by |ΔM| <= γ_N |A|ᵀ|A| entrywise in any order of
       summation (γ_N = Nu/(1 - Nu)), so ||ΔM||₂ <= γ_N tr(M);
    2. each normalised coordinate is T̂x to 2u (one rounding in x - mean,
       one in the scaling; the computed T̂ is the one that denormalises),
       and each entry of A rounds once more: ≤ 5u relative, so
       ||ΔM||₂ <= 2·5u tr(M);
    3. a backward-stable symmetric eigensolver returns an exact
       eigenvector of M + E, ||E||₂ <= p(9) u ||M||₂, p(9) = 9: <= 9u tr(M);
    4. to first order f moves by δf = Σₖ vₖ vₖᵀ ΔM f / (λ₁ - λₖ) (k = 2..9),
       and the rank-2 step and denormalisation move the unit-norm output
       by J δf, J their Jacobian, so |J δf|∞ <= ||ΔM||₂ S with
       S = Σₖ |J vₖ|∞ / (λₖ - λ₁);
    5. the two packages err independently: each set is held to
       1e-4 + 2 (γ_N/u + 19) u tr(M) S, where 1e-4 covers the f32 rounding
       of the rank-2 SVD and the denormalisation themselves.

    The observed gap is at most 0.15 of that bound's second term (20
    seeds under the default and the three MKL_CBWR code paths, which
    differ from one another in both the batched AᵀA product and ``eigh``).
    Minimal fundamental sets reach λ₁/gap ~1e8, where the bound says
    nothing, so the median over the 64 minimal sets is held too: it is at
    most 1.1e-5 for H and 6.7e-4 for F over those 20 seeds and four code
    paths, and is held to about 3x that (3e-5 and 2e-3), while a solve
    that skips rank 2 gives ~1e-2 and a wrong eigenvector or
    denormalisation ~1e-1."""
    pts = _scene(rng, 200, planar=solver == "h")
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    x2 = _project(pts, _rot_y(3.0), np.array([-0.4, 0.02, 0.05], np.float32))
    x1 = (x1 + rng.normal(0, 0.3, x1.shape)).astype(np.float32)
    x2 = (x2 + rng.normal(0, 0.3, x2.shape)).astype(np.float32)
    port, ref = ((homography.solve_h_dlt, jx_homography.solve_h_dlt) if solver == "h"
                 else (fundamental.solve_f_8point, jx_fundamental.solve_f_8point))
    if weighted:
        s1, s2 = x1[None], x2[None]
        w = (rng.random((1, 200)) < 0.7).astype(np.float32)
        got = port(_t(s1), _t(s2), _t(w)).numpy()
        want = np.asarray(ref(jnp.asarray(s1), jnp.asarray(s2), jnp.asarray(w)))
    else:
        idx = np.stack([rng.choice(200, 8, replace=False) for _ in range(64)])
        s1, s2, w = x1[idx], x2[idx], None
        got = port(_t(s1), _t(s2)).numpy()
        want = np.asarray(ref(jnp.asarray(s1), jnp.asarray(s2)))
    tol = _derived_tol(s1, s2, w, solver)
    a, b = _up_to_scale(got, want)
    err = np.abs(a - b).max(axis=(-2, -1))
    assert (err <= tol).all(), (err / tol).max()
    if not weighted:  # a refit is one well-conditioned set, held above
        assert np.median(err) < (3e-5 if solver == "h" else 2e-3), np.median(err)


def _candidates_match(R, t, jR, jt, atol):
    """Every port candidate (R, t) is one of the JAX candidates: the SVD's
    column signs may order them differently."""
    for Ri, ti in zip(R, t):
        err = [max(np.abs(Ri - Rj).max(), np.abs(ti - tj).max()) for Rj, tj in zip(jR, jt)]
        assert min(err) < atol, min(err)


def test_decompositions_match_jax_as_sets(rng):
    R, t = _rot_y(4.0), np.array([-0.8, 0.05, 0.1], np.float32)
    n = np.array([0.2, 0.0, -1.0], np.float32)
    Kinv = np.linalg.inv(K)
    H = (K @ (R - np.outer(t, n) / 4.0) @ Kinv).astype(np.float32)
    gR, gt, gv = homography.decompose_homography(_t(H), _t(K))
    jR, jt, jv = (np.asarray(a) for a in jx_homography.decompose_homography(
        jnp.asarray(H), jnp.asarray(K)))
    np.testing.assert_array_equal(gv.numpy(), jv)
    # 3x3 SVD in f32 on a homography of unit scale: a few 1e-6
    _candidates_match(gR.numpy(), gt.numpy(), jR, jt, 1e-4)
    tx = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]], np.float32)
    F = (Kinv.T @ tx @ R @ Kinv).astype(np.float32)
    gR, gt = fundamental.decompose_essential(_t(F), _t(K))
    jR, jt = (np.asarray(a) for a in jx_fundamental.decompose_essential(
        jnp.asarray(F), jnp.asarray(K)))
    _candidates_match(gR.numpy(), gt.numpy(), jR, jt, 1e-4)


def _triangulation_tol(P1, P2, x1, x2):
    """Per-point bound on the distance between the two packages' points,
    derived as for the solvers (test_solvers_match_jax_up_to_scale), in
    float64 from the same f32 inputs. Each package forms the 4x4 DLT rows
    x·P[2] - P[c] (two roundings: |δA| <= γ₂ Ā, Ā = |x||P[2]| + |P[c]|),
    M = AᵀA over 4 rows (γ₄ tr M) and its least eigenvector X (4u tr M),
    so ||ΔM||₂ <= 2 γ₂ ||A||_F ||Ā||_F + (γ₄ + 4u) tr M; the point
    p = X[:3] / X[3] moves to first order by at most
    ||ΔM||₂ Σₖ ||J vₖ||₂ / (λₖ - λ₁), J vₖ = (vₖ[:3] - p vₖ[3]) / X[3].
    Two packages, and 4u ||p|| each for the division."""
    rows, bars = [], []
    for P, x in ((P1.astype(np.float64), x1.astype(np.float64)),
                 (P2.astype(np.float64), x2.astype(np.float64))):
        for c in (0, 1):
            rows.append(x[:, c:c + 1] * P[2] - P[c])
            bars.append(np.abs(x[:, c:c + 1]) * np.abs(P[2]) + np.abs(P[c]))
    A, A_bar = np.stack(rows, 1), np.stack(bars, 1)  # [N, 4, 4]
    lam, V = np.linalg.eigh(np.swapaxes(A, -1, -2) @ A)
    w = V[:, 3:4, 0]
    p = V[:, :3, 0] / w
    g2, g4 = 2 * _U / (1 - 2 * _U), 4 * _U / (1 - 4 * _U)
    dM = (2 * g2 * np.linalg.norm(A, axis=(-2, -1)) * np.linalg.norm(A_bar, axis=(-2, -1))
          + (g4 + 4 * _U) * lam.sum(-1))
    S = sum(np.linalg.norm((V[:, :3, k] - p * V[:, 3:4, k]) / w, axis=-1)
            / (lam[:, k] - lam[:, 0]) for k in range(1, 4))
    return 2 * (dM * S + 4 * _U * np.linalg.norm(p, axis=-1))


def test_triangulate_matches_jax(rng):
    pts = _scene(rng, 64)
    R, t = _rot_y(3.0), np.array([-0.4, 0.0, 0.05], np.float32)
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32)).astype(np.float32)
    x2 = _project(pts, R, t).astype(np.float32)
    eye34 = np.concatenate([np.eye(3), np.zeros((3, 1))], 1).astype(np.float32)
    P1 = (K @ eye34)[None]
    P2 = (K @ np.concatenate([R, t[:, None]], 1))[None].astype(np.float32)
    ref = np.asarray(jx_triangulate(jnp.asarray(P1), jnp.asarray(P2),
                                    jnp.asarray(x1[None]), jnp.asarray(x2[None])))[0]
    got = triangulate_dlt(_t(P1), _t(P2), _t(x1[None]), _t(x2[None])).numpy()[0]
    # each point to its derived bound, 2e-4 to 7e-4 of the point's norm
    # here (the observed gap is at most 0.07 of it over 20 seeds)
    dist = np.linalg.norm(got - ref, axis=-1)
    tol = _triangulation_tol(P1[0], P2[0], x1, x2)
    assert (dist <= tol).all(), (dist / tol).max()
    np.testing.assert_allclose(got, pts, atol=5e-2)


# --- initialize_two_view on the scenes of tests/test_twoview.py -----------

def _general(rng):
    pts = _scene(rng)
    R, t = _rot_y(2.0), np.array([-0.3, 0.02, 0.01], np.float32)
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    x2 = _project(pts, R, t)
    return (x1 + rng.normal(0, 0.5, x1.shape), x2 + rng.normal(0, 0.5, x2.shape),
            {"ransac_iterations": 500})


def _planar(rng):
    pts = _scene(rng, planar=True)
    R, t = _rot_y(5.0), np.array([-1.5, 0.0, 0.0], np.float32)
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    x2 = _project(pts, R, t)
    return (x1 + rng.normal(0, 0.4, x1.shape), x2 + rng.normal(0, 0.4, x2.shape),
            {"ransac_iterations": 500, "rh_threshold": 0.40})


def _pure_rotation(rng):
    pts = _scene(rng)
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    x2 = _project(pts, _rot_y(3.0), np.zeros(3, np.float32))
    return (x1 + rng.normal(0, 0.3, x1.shape), x2 + rng.normal(0, 0.3, x2.shape),
            {"ransac_iterations": 500})


def _too_few(rng):
    x1 = rng.uniform(0, 700, (60, 2))
    return x1, x1 + rng.normal(0, 2, x1.shape), {"ransac_iterations": 500}


def _outliers(rng):
    pts = _scene(rng)
    R, t = _rot_y(2.0), np.array([-0.3, 0.0, 0.02], np.float32)
    x1 = _project(pts, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    x2 = _project(pts, R, t)
    x2[:75] = rng.uniform(0, 700, (75, 2))
    return x1, x2, {"ransac_iterations": 1000}


def _jax_uniforms(key, iters):
    kh, kf = jax.random.split(key)
    return (np.asarray(jax.random.uniform(kh, (iters, 8))),
            np.asarray(jax.random.uniform(kf, (iters, 8))))


def _compare_two_view(got, ref, f_determined=True, rh_threshold=None):
    """The RANSAC winner's refit on its inliers decides everything, and its
    inlier set can differ from JAX's by one borderline match (the f32 null
    vectors of the two packages differ, test_solvers_match_jax_up_to_scale):

    - success and the model choice are identical;
    - where the points do not fix F (``f_determined`` False: coplanar
      points, or no translation, leave the 8-point system a null space of
      dimension three or more, up to noise), which F each hypothesis takes
      is up to the eigensolver. There the F score, and the counts and
      parallax of a pose taken from F, are held only to what the data
      determine: the model choice, and the side of ``rh_threshold`` on
      which SH / (SH + SF) falls;
    - otherwise the inlier and vetted counts are identical on a scene that
      initializes, and within one on one that does not; the parallax
      statistic (the 51st-largest angle) within 0.05 degrees; each score
      within 12: one match adds at most 2 x 5.991;
    - where the pair initializes, R21 to 1e-3 (a refit on a set that
      differs by one match among ~300 moves it by ~3e-4) and the direction
      of t21 to 1 degree. The winner may be a minimal 8-point hypothesis
      (it is on ``_general``), whose f32 null vector no bound independent
      of the BLAS/LAPACK build holds (test_solvers_match_jax_up_to_scale):
      there the two packages' t21 part by 0.02 degrees on the default MKL
      code path and by 0.25 under MKL_CBWR (and by 0.06 on the rendered
      pair, whose data fix t21 only to ~7 degrees). 1 degree is 4x the
      largest parting seen and far below the 180 degrees between the sign
      candidates; test_twoview.py holds JAX's t21 to 5 degrees of the truth;
    - the vetted-point mask in all but two matches, and the points where
      both vetted them to 1e-2 relative (distant points amplify the pose)."""
    for f in ("success", "used_homography"):
        assert bool(getattr(got, f)) == bool(getattr(ref, f)), f
    if not f_determined:
        rh = [float(r.score_h) / (float(r.score_h) + float(r.score_f)) for r in (got, ref)]
        assert (rh[0] > rh_threshold) == (rh[1] > rh_threshold), rh
    if f_determined or bool(ref.used_homography):
        slack = 0 if bool(ref.success) else 1
        for f in ("n_inliers", "n_good"):
            assert abs(int(getattr(got, f)) - int(getattr(ref, f))) <= slack, f
        assert abs(float(got.parallax_deg) - float(ref.parallax_deg)) <= 0.05
    for f in ("score_h", "score_f") if f_determined else ("score_h",):
        assert abs(float(getattr(got, f)) - float(getattr(ref, f))) <= 12.0, f
    if bool(ref.success):
        np.testing.assert_allclose(got.R21.numpy(), np.asarray(ref.R21), atol=1e-3, rtol=0)
        cos_t = float(got.t21.numpy() @ np.asarray(ref.t21))  # both unit norm
        assert np.degrees(np.arccos(np.clip(cos_t, -1.0, 1.0))) <= 1.0
    gm, rm = got.tri_mask.numpy(), np.asarray(ref.tri_mask)
    assert (gm != rm).sum() <= 2
    both = gm & rm
    gp, rp = got.points3d.numpy()[both], np.asarray(ref.points3d)[both]
    dist = np.linalg.norm(gp - rp, axis=-1)
    assert (dist <= 1e-2 * np.linalg.norm(rp, axis=-1)).all()


@pytest.mark.parametrize("scene", [_general, _planar, _pure_rotation, _too_few, _outliers])
def test_initialize_two_view_matches_jax(rng, scene):
    x1, x2, kwargs = scene(rng)
    x1, x2 = x1.astype(np.float32), x2.astype(np.float32)
    cfg = InitConfig(**kwargs)
    valid = np.ones(x1.shape[0], bool)
    key = jax.random.PRNGKey(0)
    ref = jx_init(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), jnp.asarray(K),
                  key, _jx(cfg))
    u_h, u_f = _jax_uniforms(key, cfg.ransac_iterations)
    got = initialize_two_view(_t(x1), _t(x2), _t(valid), _t(K), _t(u_h), _t(u_f), cfg)
    _compare_two_view(got, ref, f_determined=scene not in (_planar, _pure_rotation, _too_few),
                      rh_threshold=cfg.rh_threshold)
    if scene in (_general, _planar, _outliers):
        assert bool(got.success)
    if scene in (_pure_rotation, _too_few):
        assert not bool(got.success)


def test_intrinsics_matrix_matches_jax():
    cam = CameraConfig(fx=609.2855, fy=609.3422, cx=351.4274, cy=237.7324)
    np.testing.assert_array_equal(camera.intrinsics_matrix(cam, "cpu").numpy(),
                                  np.asarray(jx_camera.intrinsics_matrix(_jx(cam))))


def test_keypoints_from_numpy_round_trip():
    kps = jx_orb_extract(jnp.asarray(_pair()[0]), _jx(_OCFG))
    got = keypoints_from_numpy(kps, device="cpu")
    assert got.desc.dtype == torch.int32
    back = keypoints_to_numpy(got)
    for f in kps._fields:
        np.testing.assert_array_equal(back[f], np.asarray(getattr(kps, f)), err_msg=f)
    np.testing.assert_array_equal(
        keypoints_from_numpy(back, device="cpu").desc.numpy(), got.desc.numpy())


# --- the whole slice on a rendered 320x240 pair -----------------------------

_CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, width=320, height=240)
# init_orb: 1000 features over 4 levels; a 320x240 pair has ~75 matches, so
# the match gate is lowered from 100 to 50
_SYS = SystemConfig(camera=_CAM, orb=OrbConfig(n_features=500, n_levels=4),
                    init=InitConfig(min_matches=50))
_OCFG = _SYS.init_orb


@functools.lru_cache(maxsize=1)
def _pair():
    field = CornerField(np.random.default_rng(7), n=INIT_FIELD_POINTS)
    poses = make_trajectory(INIT_FRAMES, "strafe")
    return tuple(render_frame(field, _CAM, *poses[i]).astype(np.float32)
                 for i in INIT_PAIR)


@functools.lru_cache(maxsize=1)
def _jax_slice():
    cam, ocfg = _jx(_CAM), _jx(_OCFG)
    k1, k2 = (jx_orb_extract(jnp.asarray(img), ocfg) for img in _pair())
    un1 = jx_camera.undistort_pixels(cam, k1.xy)
    un2 = jx_camera.undistort_pixels(cam, k2.xy)
    res = jx_search(k1.desc, un1, k1.octave, k1.angle_deg, k1.valid,
                    k2.desc, un2, k2.octave, k2.angle_deg, k2.valid, _jx(_SYS.matcher))
    pairs, pv = jx_compact(res.matches12, _SYS.matcher.max_matches)
    x1, x2 = un1[pairs[:, 0]], un2[pairs[:, 1]]
    key = jax.random.PRNGKey(0)
    tv = jx_init(x1, x2, pv, jx_camera.intrinsics_matrix(cam), key, _jx(_SYS.init))
    return k1, k2, res, (np.asarray(pairs), np.asarray(pv)), (np.asarray(x1), np.asarray(x2)), tv


def test_matcher_on_jax_keypoints():
    """The JAX package's keypoints of the pair, converted, match identically."""
    k1, k2, ref, _, _, _ = _jax_slice()
    a, b = (keypoints_from_numpy(k, device="cpu") for k in (k1, k2))
    got = search_for_initialization(a.desc, a.xy, a.octave, a.angle_deg, a.valid,
                                    b.desc, b.xy, b.octave, b.angle_deg, b.valid,
                                    _SYS.matcher)
    assert int(ref.n_matches) > 50
    for f in MatchResult._fields:
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_two_view_initializer_matches_jax():
    """The per-pair module on the CPU against the JAX chain orb_extract ->
    undistort_pixels -> search_for_initialization -> compact_matches ->
    initialize_two_view. Keypoints, their descriptors and the matches are
    identical;
    the geometry is compared on the same matches with JAX's uniforms, and
    the module's own run (its generator's uniforms) recovers the ground
    truth."""
    k1, k2, res, (pairs, pv), (x1, x2), ref = _jax_slice()
    init = TwoViewInitializer(_CAM, _OCFG, _SYS.matcher, _SYS.init, device="cpu")
    got = init(*(torch.from_numpy(img) for img in _pair()),
               torch.Generator().manual_seed(0))
    for mine, theirs in ((got.kps1, k1), (got.kps2, k2)):
        m = keypoints_to_numpy(mine)
        for f in ("xy", "octave", "valid"):
            np.testing.assert_array_equal(m[f], np.asarray(getattr(theirs, f)), err_msg=f)
        # rows past a level's corners are padding: their descriptors are
        # sampled at arbitrary pixels and not compared
        valid = m["valid"]
        np.testing.assert_array_equal(m["desc"][valid], np.asarray(theirs.desc)[valid])
    for f in MatchResult._fields:
        np.testing.assert_array_equal(getattr(got.matches, f).numpy(),
                                      np.asarray(getattr(res, f)), err_msg=f)
    np.testing.assert_array_equal(got.pairs.numpy(), pairs)
    np.testing.assert_array_equal(got.pair_valid.numpy(), pv)

    u_h, u_f = _jax_uniforms(jax.random.PRNGKey(0), _SYS.init.ransac_iterations)
    same_u = initialize_two_view(_t(x1), _t(x2), _t(pv), init.K, _t(u_h), _t(u_f),
                                 _SYS.init)
    _compare_two_view(same_u, ref)
    assert bool(ref.success)

    tv = got.two_view
    assert bool(tv.success) and not bool(tv.used_homography)
    poses = make_trajectory(INIT_FRAMES, "strafe")
    (R1, t1), (R2, t2) = (poses[i] for i in INIT_PAIR)
    R21 = R2 @ R1.T
    rerr, terr = _pose_errors_deg(tv, R21, t2 - R21 @ t1)
    assert rerr < 0.5 and terr < 10.0, (rerr, terr)
    assert int(tv.tri_mask.sum()) >= _SYS.init.min_triangulated


def _pose_errors_deg(tv, R21, t21):
    """Rotation error and the angle between t21 and the true translation."""
    R = tv.R21.numpy().astype(np.float64)
    t = tv.t21.numpy().astype(np.float64)
    rerr = np.degrees(np.arccos(np.clip((np.trace(R.T @ R21) - 1) / 2, -1, 1)))
    terr = np.degrees(np.arccos(np.clip(t @ t21 / np.linalg.norm(t21), -1, 1)))
    return rerr, terr


def test_init_entry_initializes_on_the_cpu():
    """The init operating point (640x480, 2000 keypoints, 200 hypotheses)
    initializes, within the bounds chip_smoke.py holds the card to."""
    forward, args, R21, t21 = init_entry("cpu")
    assert tuple(args[0].shape) == (480, 640) and args[0].device.type == "cpu"
    out = forward(*args)
    tv = out.two_view
    assert out.kps1.desc.shape == (2048, 8)
    assert int(out.matches.n_matches) >= 100
    assert bool(tv.success) and not bool(tv.used_homography)
    rerr, terr = _pose_errors_deg(tv, R21, t21)
    assert rerr <= 0.5 and terr <= 5.0, (rerr, terr)
    again = forward(*args).two_view  # the generator is seeded on every call
    assert torch.equal(again.R21, tv.R21) and torch.equal(again.t21, tv.t21)


@pytest.mark.parametrize("build", [
    lambda: TwoViewInitializer(_CAM, _OCFG, _SYS.matcher, _SYS.init),
    lambda: init_entry(),
    lambda: ExtractorConstants(240, 320, _OCFG),
    lambda: gauss_taps(),
], ids=["TwoViewInitializer", "init_entry", "ExtractorConstants", "gauss_taps"])
def test_init_entry_points_default_to_the_card(monkeypatch, build):
    """Without a CUDA device, an entry point not given device="cpu" raises
    instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build()
