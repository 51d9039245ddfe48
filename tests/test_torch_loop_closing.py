"""The port's loop closing beside the JAX package's, on the CPU, on the
drifted loop of tests/test_loop_closing.py (``loop_world``): the port's
copy of the fixture's builder equals the JAX one, and from the same map
and database (the JAX fixture's, converted) both detect the same
candidates, solve the same Sim(3) with JAX's RANSAC draws (seeded by the
global ratio test, or under a vocabulary by SearchByBoW and its fallback)
and close the loop to nearly the same poses; the JAX tests' own assertions hold on the
port, with and without global BA and in the physical-drift regime."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_loop_closing as jx_tests
from orb_slam_tracking_tpu.bow.vocabulary import Vocabulary as JxVocabulary
from orb_slam_tracking_tpu.slam import loop_closing as jx_loop_closing
from orb_slam_tracking_tpu.slam.loop_closing import LoopCloser as JxLoopCloser
from orb_slam_tracking_tpu_torch.bow.database import KeyframeDatabase
from orb_slam_tracking_tpu_torch.convert import slam_map_from_numpy, slam_map_to_numpy
from orb_slam_tracking_tpu_torch.ops import hamming
from orb_slam_tracking_tpu_torch.slam import loop_closing
from orb_slam_tracking_tpu_torch.slam.loop_closing import LoopCloser, covisibility_matrix
from orb_slam_tracking_tpu_torch.utils import loop_world as lw
from orb_slam_tracking_tpu_torch.utils.metrics import ate_rmse

N_KF = lw.N_KF


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread is as fast, and keeps this file's
    worker from spinning against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port_world(jw):
    """The JAX fixture's map and database as the port's tensors."""
    m = slam_map_from_numpy({f: np.asarray(getattr(jw["m"], f)) for f in jw["m"]._fields},
                            device="cpu")
    db = KeyframeDatabase(*(torch.tensor(np.asarray(x)) for x in jw["db"]))
    return m, db


def _jax_draws(lc):
    """JAX's RANSAC uniforms for the port's loop closer: ``PRNGKey`` of the
    closer's counter, as the JAX closer draws them."""
    lc._uniforms = lambda shape: torch.tensor(np.asarray(
        jax.random.uniform(jax.random.PRNGKey(lc._key_counter), shape)))
    return lc


def _cfg(gba):
    """The fixture's configuration in both packages (the port's copy:
    the tracker's fields all equal, the camera's where the port has them)."""
    jcfg = jx_tests._cfg()
    jcfg = dataclasses.replace(jcfg, tracker=dataclasses.replace(
        jcfg.tracker, loop_global_ba_iterations=gba))
    pcfg = lw.loop_world_config(gba)
    assert dataclasses.asdict(pcfg.tracker) == dataclasses.asdict(jcfg.tracker)
    for f, v in dataclasses.asdict(pcfg.camera).items():
        assert getattr(jcfg.camera, f) == v, f
    assert pcfg.orb.scale_factor == jcfg.orb.scale_factor
    return jcfg, pcfg


def _close(jw, gba):
    """on_keyframe(9) of both closers from the JAX fixture's map: ->
    (JAX map, JAX info, port map, port info, port closer)."""
    jcfg, pcfg = _cfg(gba)
    m, db = _port_world(jw)
    jm, jinfo = JxLoopCloser(jcfg, jw["K"]).on_keyframe(jw["m"], jw["db"], 9)
    lc = _jax_draws(LoopCloser(pcfg, jw["K"], device="cpu"))
    pm, pinfo = lc.on_keyframe(m, db, 9)
    return jm, jinfo, pm, pinfo, lc


@pytest.fixture(scope="module")
def jx_world():
    return jx_tests._build_loop_world(uv_from_gt=False)


@pytest.fixture(scope="module")
def jx_world_gt():
    return jx_tests._build_loop_world(uv_from_gt=True)


@pytest.fixture(scope="module")
def closed(jx_world):
    return _close(jx_world, 0)


@pytest.mark.parametrize("uv_from_gt", [False, True])
def test_loop_world_equals_jax(uv_from_gt, jx_world, jx_world_gt):
    """The port's builder against the JAX test's: integer and boolean
    fields equal, floats within 2e-5 (f32 Sim(3) products of coordinates
    up to ~10, composed in another order), the database's BoW vectors
    within 1e-6 (L1-normalized; the same words, sums in another order),
    and the same ground truth and drift scale."""
    jw = jx_world_gt if uv_from_gt else jx_world
    pw = lw.build_loop_world(uv_from_gt, device="cpu")
    ref = {f: np.asarray(getattr(jw["m"], f)) for f in jw["m"]._fields}
    got = slam_map_to_numpy(pw["m"])
    for f, a in ref.items():
        if a.dtype.kind == "f":
            np.testing.assert_allclose(got[f], a, atol=2e-5, err_msg=f)
        else:
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    np.testing.assert_allclose(pw["db"].bow.numpy(), np.asarray(jw["db"].bow), atol=1e-6)
    np.testing.assert_array_equal(pw["db"].valid.numpy(), np.asarray(jw["db"].valid))
    np.testing.assert_array_equal(pw["R_gt"], jw["R_gt"])
    np.testing.assert_array_equal(pw["t_gt"], jw["t_gt"])
    np.testing.assert_array_equal(pw["K"], jw["K"])
    assert (pw["voc"].k, pw["voc"].depth, pw["voc"].n_words) == (8, 2, 64)
    assert pw["s_drift"] == pytest.approx(jw["s_drift"], rel=1e-6)


def test_detect_equals_jax(jx_world):
    """The covisibility matrix and the candidate list exact, on the JAX
    fixture's map and on the port's own; the JAX test's assertions (no
    shared point between the revisit and the loop keyframe, the candidate
    0 or 1 first)."""
    jcfg, pcfg = _cfg(0)
    m, db = _port_world(jx_world)
    ref_shared = jx_tests.covisibility_matrix(jx_world["m"])
    np.testing.assert_array_equal(covisibility_matrix(m), ref_shared)
    ref = JxLoopCloser(jcfg, jx_world["K"]).detect(jx_world["m"], jx_world["db"], 9)
    got = LoopCloser(pcfg, jx_world["K"], device="cpu").detect(m, db, 9)
    assert got == ref and got and got[0] in (0, 1)
    pw = lw.build_loop_world(False, device="cpu")
    assert LoopCloser(pcfg, pw["K"], device="cpu").detect(pw["m"], pw["db"], 9) == ref
    assert ref_shared[9, 0] == 0 and ref_shared[9, 8] >= 5


def test_compute_sim3_equals_jax(jx_world):
    """With JAX's draws: the same inlier count and stage report, Scm
    within 1e-4 of JAX's (both refine the same grown set with the f32
    Sim(3) LM), and the JAX test's bounds (the inverse drift scale within
    0.02, the true relative rotation within 2e-2). Two B3 launches would
    be counted on the card (the two grow rounds); here the counter stays 0."""
    jcfg, pcfg = _cfg(0)
    m, _ = _port_world(jx_world)
    jlc = JxLoopCloser(jcfg, jx_world["K"])
    ref = jlc.compute_sim3(jx_world["m"], 9, 0)
    lc = _jax_draws(LoopCloser(pcfg, jx_world["K"], device="cpu"))
    got = lc.compute_sim3(m, 9, 0)
    assert got is not None and ref is not None
    assert got[1] == ref[1] >= 10
    assert lc.last_sim3_reason == jlc.last_sim3_reason
    for a, b in zip(got[0], ref[0]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)
    assert abs(float(got[0].s) - 1.0 / jx_world["s_drift"]) < 0.02
    expect_R = jx_world["R_gt"][9] @ jx_world["R_gt"][0].T
    assert np.allclose(got[0].R.numpy(), expect_R, atol=2e-2)
    assert hamming.hamming_matrix.launches == 0


@pytest.mark.parametrize("min_inliers", [10, 60])
def test_compute_sim3_with_vocabulary_equals_jax(min_inliers, jx_world, monkeypatch):
    """Both closers under the port world's vocabulary (k 8, depth 2), with
    JAX's draws: SearchByBoW's seed matches exact, and when the seeds are
    fewer than ``loop_min_inliers`` (60 > the 36 seeds) the same fallback
    to the global ratio test, its matches exact; then the same inlier
    count (or the same rejection) and stage report, Scm within 1e-4 of
    JAX's (the f32 Sim(3) LM on the same grown set). The seed matcher's
    all-pairs call is the event's first B3 launch, [128, 128]."""
    jcfg, pcfg = _cfg(0)
    jcfg = dataclasses.replace(jcfg, tracker=dataclasses.replace(
        jcfg.tracker, loop_min_inliers=min_inliers))
    pcfg = dataclasses.replace(pcfg, tracker=dataclasses.replace(
        pcfg.tracker, loop_min_inliers=min_inliers))
    voc = lw.build_loop_world(False, device="cpu")["voc"]
    jvoc = JxVocabulary(tuple(jnp.asarray(d.numpy().view(np.uint32)) for d in voc.node_desc),
                        jnp.asarray(voc.word_weight.numpy()), voc.k, voc.depth)
    seen = {"jax": [], "port": []}

    def spy(mod, name, key):
        real = getattr(mod, name)

        def wrapped(*a, **kw):
            out = real(*a, **kw)
            seen[key].append((name, np.asarray(out)))
            return out
        monkeypatch.setattr(mod, name, wrapped)

    for name in ("match_descriptors_bow", "match_descriptors"):
        spy(jx_loop_closing, name, "jax")
        spy(loop_closing, name, "port")
    calls = []
    real_hm = loop_closing.hamming_matrix
    monkeypatch.setattr(loop_closing, "hamming_matrix",
                        lambda a, b: calls.append((tuple(a.shape), tuple(b.shape))) or real_hm(a, b))
    m, _ = _port_world(jx_world)
    jlc = JxLoopCloser(jcfg, jx_world["K"], vocab=jvoc)
    ref = jlc.compute_sim3(jx_world["m"], 9, 0)
    lc = _jax_draws(LoopCloser(pcfg, jx_world["K"], vocab=voc, device="cpu"))
    got = lc.compute_sim3(m, 9, 0)
    expect = ["match_descriptors_bow"] + ["match_descriptors"] * (min_inliers > 36)
    assert [n for n, _ in seen["port"]] == [n for n, _ in seen["jax"]] == expect
    for (_, a), (_, b) in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert int((seen["port"][0][1] >= 0).sum()) == 36
    assert calls[0] == ((128, 8), (128, 8))
    assert lc.last_sim3_reason == jlc.last_sim3_reason
    assert (got is None) == (ref is None) == (min_inliers > 36)
    if got is not None:
        assert got[1] == ref[1] >= min_inliers
        for a, b in zip(got[0], ref[0]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4)


def test_correct_loop_equals_jax(jx_world, closed):
    """on_keyframe(9) closes with kf 0 on both: the same edges and fused
    points, the map's integer and boolean fields equal, poses within 1e-4
    and points within 1e-3 of JAX's (f32 pose-graph LM steps of the same
    graph; the readings are ~1e-6 and ~1e-5), the pose-graph costs within
    1e-3 relative; then test_correct_loop_shrinks_trajectory_error's
    assertions on the port's result."""
    jm, jinfo, pm, pinfo, lc = closed
    assert pinfo["loop"] == jinfo["loop"] == "closed with kf 0"
    for k in ("loop_edges", "loop_fused", "loop_inliers"):
        assert pinfo[k] == jinfo[k], k
    for k in ("loop_cost0", "loop_cost", "loop_scale"):
        assert pinfo[k] == pytest.approx(jinfo[k], rel=1e-3), k
    got, ref = slam_map_to_numpy(pm), {f: np.asarray(getattr(jm, f)) for f in jm._fields}
    for f, a in ref.items():
        if a.dtype.kind != "f":
            np.testing.assert_array_equal(got[f], a, err_msg=f)
    np.testing.assert_allclose(got["kf_R"], ref["kf_R"], atol=1e-4)
    np.testing.assert_allclose(got["kf_t"], ref["kf_t"], atol=1e-4)
    np.testing.assert_allclose(got["pts"], ref["pts"], atol=1e-3)

    m0 = jx_world["m"]
    err_before = lw.center_errors(np.asarray(m0.kf_R)[:N_KF], np.asarray(m0.kf_t)[:N_KF],
                                  jx_world["R_gt"], jx_world["t_gt"])
    err_after = lw.center_errors(got["kf_R"][:N_KF], got["kf_t"][:N_KF],
                                 jx_world["R_gt"], jx_world["t_gt"])
    assert err_before[8] > 0.5
    assert err_after[1:4].mean() <= err_before[1:4].mean() + 0.05
    assert err_after[1:9].mean() < 1.5 * err_before[1:9].mean()
    for a, b in zip(pm, _port_world(jx_world)[0]):
        assert a.shape == b.shape and a.dtype == b.dtype
    Scm, _ = _jax_draws(LoopCloser(lc.cfg, jx_world["K"], device="cpu")).compute_sim3(
        _port_world(jx_world)[0], 9, 0)
    R9, t9, R0, t0 = got["kf_R"][9], got["kf_t"][9], got["kf_R"][0], got["kf_t"][0]
    R_rel = R9 @ R0.T
    assert np.allclose(R_rel, Scm.R.numpy(), atol=3e-2)
    assert np.allclose(t9 - R_rel @ t0, Scm.t.numpy() / float(Scm.s), atol=0.1)
    assert int(pinfo["loop_fused"]) >= 10
    kp_pt2 = got["kf_kp_pt"]
    inst9, inst0 = kp_pt2[9][kp_pt2[9] >= 0], kp_pt2[0][kp_pt2[0] >= 0]
    assert len(np.intersect1d(inst9, inst0)) >= 10
    old = np.asarray(m0.kf_kp_pt)
    retired = sorted(set(old[9][old[9] >= 0].tolist()) - set(inst9.tolist()))
    assert len(retired) >= 10
    assert not got["pt_valid"][retired].any() and int(got["n_obs"][retired].sum()) == 0


def test_global_ba_is_noop_at_reprojection_minimum(jx_world):
    """The full-map BA (``max_free_cams=None``) leaves the drifted
    zero-residual map in place (the JAX test's bounds), its cost within
    1e-6 of JAX's."""
    jcfg, pcfg = _cfg(0)
    m, _ = _port_world(jx_world)
    _, jinfo = JxLoopCloser(jcfg, jx_world["K"]).global_ba(jx_world["m"])
    m2, info = LoopCloser(pcfg, jx_world["K"], device="cpu").global_ba(m)
    assert info["gba_cost0"] < 1e-5 and abs(info["gba_cost0"] - jinfo["gba_cost0"]) < 1e-6
    assert info["gba_inlier_obs"] == jinfo["gba_inlier_obs"]
    assert np.abs(m2.kf_t.numpy() - np.asarray(jx_world["m"].kf_t)).max() < 1e-4
    assert np.abs(m2.pts.numpy() - np.asarray(jx_world["m"].pts)).max() < 1e-4


def test_on_keyframe_runs_global_ba_when_enabled(jx_world):
    """With global BA on: the JAX test's assertions on the port (the cost
    down by 20x, both loop ends on >= 10 shared points), the BA's costs
    within 5 % of JAX's and its inlier count within 2 (a full-map f32 LM
    after the same closure; BA from the same state differs by its f32
    steps, see test_torch_map_ba)."""
    jm, jinfo, pm, pinfo, _ = _close(jx_world, 8)
    assert str(pinfo["loop"]).startswith("closed")
    assert pinfo["gba_cost"] < 0.05 * pinfo["gba_cost0"]
    assert pinfo["gba_cost0"] == pytest.approx(jinfo["gba_cost0"], rel=0.05)
    assert pinfo["gba_cost"] == pytest.approx(jinfo["gba_cost"], rel=0.05)
    assert abs(pinfo["gba_inlier_obs"] - jinfo["gba_inlier_obs"]) <= 2
    kp_pt2 = pm.kf_kp_pt.numpy()
    inst9, inst0 = kp_pt2[9][kp_pt2[9] >= 0], kp_pt2[0][kp_pt2[0] >= 0]
    assert len(np.intersect1d(inst9, inst0)) >= 10


def test_physical_drift_full_pipeline_recovers_ground_truth(jx_world_gt):
    """The physically consistent regime: the JAX test's assertions on the
    port (global BA to a cost under 1e-3, the trajectory error under a
    quarter of the drift and under 0.7 of the graph-only error, the
    Sim(3)-aligned ATE under 0.02), and the port's graph-only poses near
    JAX's: rotations within 1e-4, translations (of magnitude ~8) within
    5e-4 (f32 pose-graph steps from measurements composed in another
    order; the reading is 2.3e-4, 3e-5 of the magnitude)."""
    w = jx_world_gt
    m0 = w["m"]
    err_before = lw.center_errors(np.asarray(m0.kf_R)[:N_KF], np.asarray(m0.kf_t)[:N_KF],
                                  w["R_gt"], w["t_gt"])
    assert err_before[1:].mean() > 1.0
    jm, _, m_graph, info0, _ = _close(w, 0)
    np.testing.assert_allclose(m_graph.kf_R.numpy(), np.asarray(jm.kf_R), atol=1e-4)
    np.testing.assert_allclose(m_graph.kf_t.numpy(), np.asarray(jm.kf_t), atol=5e-4)
    _, pcfg = _cfg(8)
    m, db = _port_world(w)
    m_gba, info = _jax_draws(LoopCloser(pcfg, w["K"], device="cpu")).on_keyframe(m, db, 9)
    assert str(info0["loop"]).startswith("closed") and str(info["loop"]).startswith("closed")
    err_graph = lw.center_errors(m_graph.kf_R.numpy()[:N_KF], m_graph.kf_t.numpy()[:N_KF],
                                 w["R_gt"], w["t_gt"])
    err_gba = lw.center_errors(m_gba.kf_R.numpy()[:N_KF], m_gba.kf_t.numpy()[:N_KF],
                               w["R_gt"], w["t_gt"])
    assert info["gba_cost"] < 1e-3
    assert err_gba[1:].mean() < 0.25 * err_before[1:].mean()
    assert err_gba[1:].mean() < 0.7 * err_graph[1:].mean()
    ate = ate_rmse(lw.centers(m_gba.kf_R.numpy()[:N_KF], m_gba.kf_t.numpy()[:N_KF]),
                   lw.centers(w["R_gt"], w["t_gt"]))
    assert ate < 0.02


def test_loop_closer_uses_the_all_pairs_kernel(jx_world, monkeypatch):
    """One event's all-pairs Hamming calls: one per grow round ([128,
    128]; the first round's refit clears the inlier bar here, as the stage
    report says) and one fuse block per current-group keyframe ([loop
    points padded to a power of two >= 64, 128])."""
    calls = []
    real = loop_closing.hamming_matrix
    monkeypatch.setattr(loop_closing, "hamming_matrix",
                        lambda a, b: calls.append((tuple(a.shape), tuple(b.shape))) or real(a, b))
    _, pcfg = _cfg(0)
    m, db = _port_world(jx_world)
    group = set(np.where(covisibility_matrix(m)[9] >= pcfg.tracker.covis_min_shared)[0]) | {9}
    lc = _jax_draws(LoopCloser(pcfg, jx_world["K"], device="cpu"))
    _, info = lc.on_keyframe(m, db, 9)
    assert info["loop"] == "closed with kf 0"
    rounds = lc.last_sim3_reason.count("grown=")
    assert rounds == 1 and calls[:rounds] == [((128, 8), (128, 8))] * rounds
    fuse = calls[rounds:]
    assert len(fuse) == len(group)
    for (lcap, _), (n, _) in fuse:
        assert n == 128 and lcap >= 64 and lcap & (lcap - 1) == 0
