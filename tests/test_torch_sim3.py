"""Parity of the port's Sim(3) algebra, RANSAC, Sim(3) LM and Sim(3) pose
graph with the JAX package, on the CPU, on the problems of
tests/test_sim3.py and tests/test_pose_graph.py: the same seeded inputs
(and JAX's own RANSAC uniforms) go through both, and each tolerance
states its reason."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_pose_graph as jx_pg_tests
from orb_slam_tracking_tpu.geometry import sim3 as jx_sim3
from orb_slam_tracking_tpu.optim import pose_graph as jx_pg
from orb_slam_tracking_tpu_torch.geometry import se3, sim3
from orb_slam_tracking_tpu_torch.optim import pose_graph

K = np.array([[450.0, 0, 320], [0, 450, 240], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread is as fast, and keeps this file's
    worker from spinning against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.tensor(np.asarray(a))


def _port(g) -> sim3.Sim3:
    return sim3.Sim3(*(_t(x) for x in g))


def _assert_sim3_close(got, ref, atol):
    for name, a, b in zip(("s", "R", "t"), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=atol, err_msg=name)


def _random_xi(rng, scale_mag=0.3, rot_mag=0.5, t_mag=1.0):
    xi = np.zeros(7, np.float32)
    xi[0:3] = rng.normal(0, t_mag, 3)
    xi[3:6] = rng.normal(0, rot_mag, 3)
    xi[6] = rng.normal(0, scale_mag)
    return xi


# --- group operations -------------------------------------------------------

@pytest.mark.parametrize("mag", [1e-7, 1e-3, 0.5, "large"])
def test_exp_log_equal_jax(rng, mag):
    """sim3_exp and sim3_log in every small-parameter regime (the JAX
    test's magnitudes; "large": |phi| = 2.8, sigma = 0.9): within 1e-6 of
    JAX's (f32 rounding of the same closed forms), and the round trip
    within the JAX test's 1e-4 * max(mag, 1e-2) (1e-3 for the large case)."""
    if mag == "large":
        xi = np.zeros((1, 7), np.float32)
        xi[0, 0:3] = [1.5, -2.0, 0.7]
        xi[0, 3:6] = np.array([2.0, 1.5, -1.0]) * (2.8 / np.linalg.norm([2.0, 1.5, -1.0]))
        xi[0, 6] = 0.9
        tol = 1e-3
    else:
        xi = np.asarray(rng.normal(0, mag, (10, 7)), np.float32)
        tol = 1e-4 * max(mag, 1e-2)
    g_ref = jx_sim3.sim3_exp(jnp.asarray(xi))
    g = sim3.sim3_exp(_t(xi))
    _assert_sim3_close(g, g_ref, 1e-6 * max(1.0, float(np.abs(xi).max())))
    back = sim3.sim3_log(g).numpy()
    np.testing.assert_allclose(back, np.asarray(jx_sim3.sim3_log(g_ref)), atol=2e-6 + tol / 10)
    np.testing.assert_allclose(back, xi, atol=tol)


def test_so3_log_equals_jax(rng):
    """so3_log through the quaternion, every pivot taken (rotations up to
    pi and the identity): within 2e-6 rad of JAX's."""
    from orb_slam_tracking_tpu.geometry import se3 as jx_se3

    axes = rng.normal(size=(64, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    ang = np.concatenate([[0.0, 1e-9, np.pi - 1e-4, np.pi], rng.uniform(0, np.pi, 60)])
    w = (axes * ang[:, None]).astype(np.float32)
    R = np.asarray(jx_se3.so3_exp(jnp.asarray(w)))
    got = se3.so3_log(_t(R)).numpy()
    ref = np.asarray(jx_se3.so3_log(jnp.asarray(R)))
    np.testing.assert_allclose(got, ref, atol=2e-6)


def test_compose_inverse_apply_equal_jax(rng):
    """compose, inverse and apply: within 1e-5 of JAX's (f32 products of
    values up to ~5), and the JAX test's identities within its 1e-4."""
    a, b = _random_xi(rng), _random_xi(rng)
    X = rng.normal(0, 1, (20, 3)).astype(np.float32)
    ja, jb = jx_sim3.sim3_exp(jnp.asarray(a)), jx_sim3.sim3_exp(jnp.asarray(b))
    pa, pb = sim3.sim3_exp(_t(a)), sim3.sim3_exp(_t(b))
    _assert_sim3_close(sim3.sim3_compose(pa, pb), jx_sim3.sim3_compose(ja, jb), 1e-5)
    _assert_sim3_close(sim3.sim3_inverse(pa), jx_sim3.sim3_inverse(ja), 1e-5)
    ab = sim3.sim3_apply(sim3.sim3_compose(pa, pb), _t(X)).numpy()
    np.testing.assert_allclose(ab, np.asarray(jx_sim3.sim3_apply(jx_sim3.sim3_compose(ja, jb),
                                                                 jnp.asarray(X))), atol=1e-5)
    np.testing.assert_allclose(ab, sim3.sim3_apply(pa, sim3.sim3_apply(pb, _t(X))).numpy(),
                               atol=1e-4)
    ident = sim3.sim3_compose(pa, sim3.sim3_inverse(pa))
    np.testing.assert_allclose(sim3.sim3_apply(ident, _t(X)).numpy(), X, atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_horn_equals_jax(rng, weighted):
    """The weighted Horn solve on the JAX test's exact problem: within 1e-5
    of JAX's (two f32 3x3 SVDs of the same cross-covariance; the solution
    is unique here), and the truth within the JAX test's 1e-4."""
    xi = _random_xi(rng)
    X2 = rng.normal(0, 2, (30, 3)).astype(np.float32)
    g = jx_sim3.sim3_exp(jnp.asarray(xi))
    X1 = np.asarray(jx_sim3.sim3_apply(g, jnp.asarray(X2)))
    w = rng.uniform(0.2, 1.0, 30).astype(np.float32) if weighted else None
    ref = jx_sim3.solve_sim3_horn(jnp.asarray(X1), jnp.asarray(X2),
                                  None if w is None else jnp.asarray(w))
    got = sim3.solve_sim3_horn(_t(X1), _t(X2), None if w is None else _t(w))
    _assert_sim3_close(got, ref, 1e-5)
    _assert_sim3_close(got, g, 1e-4)


@pytest.mark.parametrize("outliers", [0.0, 0.3])
def test_ransac_sim3_with_jax_draws(rng, outliers):
    """JAX's uniforms handed to the port: the inlier mask exact (every
    point's error is far from the 0.05 gate on this problem), the
    estimate within 1e-4 of JAX's, and the JAX test's bounds."""
    xi = _random_xi(rng)
    g = jx_sim3.sim3_exp(jnp.asarray(xi))
    N = 64
    X2 = rng.normal(0, 2, (N, 3)).astype(np.float32)
    X1 = np.array(jx_sim3.sim3_apply(g, jnp.asarray(X2)))
    out = rng.random(N) < outliers
    X1[out] += rng.normal(0, 2.0, (out.sum(), 3))
    valid = np.ones(N, bool)
    valid[-4:] = False
    key = jax.random.PRNGKey(0)
    ref = jx_sim3.ransac_sim3(jnp.asarray(X1), jnp.asarray(X2), jnp.asarray(valid), key,
                              iterations=256, tol=0.05)
    u = np.asarray(jax.random.uniform(key, (256, 3)))
    got = sim3.ransac_sim3(_t(X1), _t(X2), _t(valid), _t(u), tol=0.05)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    assert int(got.n_inliers) == int(ref.n_inliers) and bool(got.ok) == bool(ref.ok)
    _assert_sim3_close(got.g, ref.g, 1e-4)
    inl = got.inliers.numpy()
    assert bool(got.ok) and inl[~out & valid].mean() > 0.9 and not inl[~valid].any()
    if outliers:
        assert inl[out].mean() < 0.2
    assert abs(float(got.g.s) - float(g.s)) < 0.05 * float(g.s)


def _reprojection_problem(rng, xi_gt, N, noise, dxi):
    g_gt = jx_sim3.sim3_exp(jnp.asarray(xi_gt))
    X2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N),
                   rng.uniform(4, 9, N)], -1).astype(np.float32)
    X1 = np.asarray(jx_sim3.sim3_apply(g_gt, jnp.asarray(X2)))

    def proj(P):
        return (P[:, :2] / P[:, 2:]) * 450.0 + np.array([320.0, 240.0])

    uv1 = (proj(X1) + noise(N)).astype(np.float32)
    uv2 = (proj(X2) + noise(N)).astype(np.float32)
    g0 = jx_sim3.sim3_compose(jx_sim3.sim3_exp(jnp.asarray(dxi)), g_gt)
    return g_gt, g0, X1, X2, uv1, uv2


@pytest.mark.parametrize("case", ["refine", "fix_scale", "gate"])
def test_optimize_sim3_equals_jax(rng, case):
    """The three LM problems of tests/test_sim3.py (a perturbed start with
    0.3 px noise; scale fixed; ~3 px symmetric offsets about the
    per-direction gate): the estimate within 1e-4 of JAX's (f32 normal
    equations of the same residuals, each step taken or rejected alike),
    the inlier mask exact, and the JAX test's own bounds."""
    if case == "refine":
        xi_gt = _random_xi(rng, scale_mag=0.2, rot_mag=0.3, t_mag=0.5)
        dxi = np.array([0.1, 0.1, 0.1, 0.05, 0.05, 0.05, 0.08], np.float32)
        prob = _reprojection_problem(rng, xi_gt, 80, lambda n: rng.normal(0, 0.3, (n, 2)), dxi)
        kw = dict(iterations=15)
    elif case == "fix_scale":
        xi_gt = _random_xi(rng, scale_mag=0.0)
        dxi = np.array([0.1, 0, 0, 0, 0, 0, 0], np.float32)
        prob = _reprojection_problem(rng, xi_gt, 60, lambda n: np.zeros((n, 2)), dxi)
        kw = dict(iterations=12, fix_scale=True)
    else:
        xi_gt = np.zeros(7, np.float32)
        prob = _reprojection_problem(
            rng, xi_gt, 64,
            lambda n: 2.98 / np.sqrt(2) * rng.choice([-1.0, 1.0], (n, 2)), np.zeros(7, np.float32))
        kw = dict(iterations=8)
    g_gt, g0, X1, X2, uv1, uv2 = prob
    N = X1.shape[0]
    ref, ref_inl = jx_sim3.optimize_sim3(g0, *map(jnp.asarray, (X1, X2, uv1, uv2, K)),
                                         jnp.ones(N, bool), **kw)
    got, inl = sim3.optimize_sim3(_port(g0), _t(X1), _t(X2), _t(uv1), _t(uv2), _t(K),
                                  torch.ones(N, dtype=torch.bool), **kw)
    _assert_sim3_close(got, ref, 1e-4)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(ref_inl))
    if case == "refine":
        assert abs(float(got.s) / float(g_gt.s) - 1.0) < 0.01
        np.testing.assert_allclose(got.t.numpy(), np.asarray(g_gt.t), atol=0.03)
        assert inl.numpy().mean() > 0.9
    elif case == "fix_scale":
        assert abs(float(got.s) - float(g0.s)) < 1e-6
        np.testing.assert_allclose(got.t.numpy(), np.asarray(g_gt.t), atol=0.02)
    else:
        assert inl.numpy().mean() > 0.9


# --- pose graph -------------------------------------------------------------

def _pg_problem(name):
    """tests/test_pose_graph.py's problems: (vertices, v_valid, fixed, ei,
    ej, meas, weights, iterations)."""
    t = jx_pg_tests
    K_ = {"noop": 8, "recover": 16, "drift": 20, "padding": 8}[name]
    gt = t._circle_poses(K_)
    S = jx_sim3.Sim3
    fixed = jnp.zeros(K_, bool).at[0].set(True)
    if name == "drift":
        init = t._drifted(gt, rot_d=0.01, t_d=0.03, s_d=0.015, seed=3)
        ei, ej = t._chain_edges(K_, close_loop=False)
        meas = jx_pg.relative_sim3(S(init.s[ei], init.R[ei], init.t[ei]),
                                   S(init.s[ej], init.R[ej], init.t[ej]))
        loop = jx_pg.relative_sim3(S(gt.s[K_ - 1], gt.R[K_ - 1], gt.t[K_ - 1]),
                                   S(gt.s[0], gt.R[0], gt.t[0]))
        ei = jnp.concatenate([ei, jnp.array([K_ - 1], jnp.int32)])
        ej = jnp.concatenate([ej, jnp.array([0], jnp.int32)])
        meas = S(*(jnp.concatenate([a, b[None]]) for a, b in zip(meas, loop)))
        return init, jnp.ones(K_, bool), fixed, ei, ej, meas, jnp.ones(ei.shape[0]), 30
    ei, ej = t._chain_edges(K_, close_loop=True)
    meas = jx_pg.relative_sim3(S(gt.s[ei], gt.R[ei], gt.t[ei]), S(gt.s[ej], gt.R[ej], gt.t[ej]))
    if name == "noop":
        return gt, jnp.ones(K_, bool), fixed, ei, ej, meas, jnp.ones(K_), 5
    if name == "recover":
        init = t._drifted(gt, rot_d=0.02, t_d=0.05, s_d=0.01)
        return init, jnp.ones(K_, bool), fixed, ei, ej, meas, jnp.ones(ei.shape[0]), 25
    init = t._drifted(gt, rot_d=0.02, t_d=0.05, s_d=0.01, seed=1)
    pad = lambda a, fill: jnp.concatenate([a, jnp.full((2,) + a.shape[1:], fill, a.dtype)])  # noqa: E731
    verts = S(pad(init.s, 1.0), jnp.concatenate([init.R, jnp.stack([jnp.eye(3)] * 2)]),
              pad(init.t, 0.0))
    ei = jnp.concatenate([ei, jnp.array([K_, K_ + 1], jnp.int32)])
    ej = jnp.concatenate([ej, jnp.array([0, 3], jnp.int32)])
    meas = S(pad(meas.s, 1.0), jnp.concatenate([meas.R, jnp.stack([jnp.eye(3)] * 2)]),
             pad(meas.t, 123.0))
    w = jnp.concatenate([jnp.ones(K_), jnp.zeros(2)])
    v_valid = jnp.concatenate([jnp.ones(K_, bool), jnp.zeros(2, bool)])
    return (verts, v_valid, jnp.zeros(K_ + 2, bool).at[0].set(True), ei, ej, meas, w, 25)


@pytest.mark.parametrize("name", ["noop", "recover", "drift", "padding"])
def test_pose_graph_equals_jax(name):
    """Each problem solved by both: the vertices within 2e-5 of JAX's
    (f32 LM steps through Cholesky factors of the same normal equations;
    the readings are ~2e-6 on the rotations and scales and ~2e-6 on
    translations of magnitude 5), the costs within 1e-4 relative plus
    1e-9, and the Jacobian at x = 0 of the first step finite and within
    1e-4 of jax.jacfwd's (forward mode through the same branch-free
    closed forms; entries up to ~2)."""
    verts, v_valid, fixed, ei, ej, meas, w, iters = _pg_problem(name)
    ref = jx_pg.optimize_pose_graph(verts, v_valid, fixed, ei, ej, meas, w.astype(jnp.float32),
                                    iterations=iters)
    got = pose_graph.optimize_pose_graph(_port(verts), _t(v_valid), _t(fixed), _t(ei), _t(ej),
                                         _port(meas), _t(w).float(), iterations=iters)
    _assert_sim3_close(got.vertices, ref.vertices, 2e-5)
    for a, b in ((got.cost0, ref.cost0), (got.cost, ref.cost)):
        assert float(a) == pytest.approx(float(b), rel=1e-4, abs=1e-9)

    Kn, E = verts.s.shape[0], ei.shape[0]
    meas_inv = jx_sim3.sim3_inverse(meas)
    jx_J = jax.jit(jax.jacfwd(lambda x: jx_pg._residuals(jx_pg._perturbed(verts, x.reshape(Kn, 7)),
                                                 meas_inv, ei, ej).reshape(E * 7)))(
        jnp.zeros(Kn * 7))
    pm_inv, pv = sim3.sim3_inverse(_port(meas)), _port(verts)
    pei, pej = _t(ei).long(), _t(ej).long()
    J = torch.func.jacfwd(lambda x: pose_graph._residuals(
        pose_graph._perturbed(pv, x.reshape(Kn, 7)), pm_inv, pei, pej).reshape(E * 7))(
        torch.zeros(Kn * 7)).numpy()
    assert np.isfinite(J).all() and np.isfinite(np.asarray(jx_J)).all()
    np.testing.assert_allclose(J, np.asarray(jx_J), atol=1e-4)
