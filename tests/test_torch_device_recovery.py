"""The device loop's LOST-recovery tier and the inserts after it, against
the JAX package's, on the CPU (ROADMAP C11).

From ``test_torch_device_loop``'s bootstrap (the JAX ``Tracker`` on the
40-frame strafe at that file's small map configuration), both packages'
loops run 14 frames whose frames 2-7 are blank: six frames LOST, the
recovery tier (a wide re-match from the last good pose and a widened-basin
pose LM, then the narrow re-match) re-acquires the map, and keyframes are
inserted after it. On the card the port's ATE after such a recovery
(``eval_tum --blackout 120,150 --device-loop``) read 3.41 cm against
JAX's 1.61, and 5.97 for the same code on the CPU: after a long blackout
the recovered pose and the map built from it are that sensitive to f32
rounding in either package. This file pins that the rules agree: from one
state the packages take the same recovery and inserts. On the way one
rule did differ: the projection matcher's predicted octave,
``ceil(log(dmax / dist) / log(s))``, took log(s) in float64, 5e-8 below
JAX's f32 constant, and where the ratio is an exact power of s (a point
seen from the distance its statistics were taken at) the ceil rose by a
level and moved the point's window and octave gate.
``test_predicted_octave_on_a_power_of_s`` pins that rule.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.ops.proj_matcher import search_by_projection as jx_sbp
from orb_slam_tracking_tpu.slam import device_mapping as jx_dm
from orb_slam_tracking_tpu_torch.ops.proj_matcher import search_by_projection
from orb_slam_tracking_tpu_torch.slam import device_mapping as dm
from test_torch_device_loop import (CAPS, CFG, _assert_outputs_close, _jx_map, _port_map, _t,
                                    boot)  # noqa: F401  (boot is the shared fixture)
from test_torch_tracker import _rot_err_deg, jx_cfg

T = 14
BLANK = (2, 8)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def blackout(boot):
    jcfg = jx_cfg(CFG)
    run = jx_dm.make_device_sequence_loop(jcfg.camera, jcfg.orb, jcfg.matcher, jcfg.tracker,
                                          **CAPS)
    port = dm.make_device_sequence_loop(CFG.camera, CFG.orb, CFG.matcher, CFG.tracker,
                                        device="cpu", **CAPS)
    R, t, K, fid, kfc, ref = boot["state"]
    imgs = boot["frames"][boot["start"]:boot["start"] + T].copy()
    imgs[BLANK[0]:BLANK[1]] = 0.0
    jm, jo = run(jnp.asarray(imgs), _jx_map(boot["fields"]), jnp.asarray(R), jnp.asarray(t),
                 jnp.asarray(K), jnp.int32(fid), jnp.int32(kfc), jnp.int32(ref))
    pm, po = port(_t(imgs), _port_map(boot), _t(R), _t(t), _t(K), fid, kfc, ref)
    return jm, jo, pm, po


def test_recovery_and_inserts_after_it_match_jax(boot, blackout):
    """Both lose the six blank frames, re-acquire on the same frame and
    insert the same keyframes after it; n_inliers within 3 % + 3 and every
    pose, the recovered ones included, within 2e-3 of JAX's
    (test_torch_device_loop's bounds); the keyframes' poses after the
    inserts' local BA within 2e-3 too, and the end rotation within 0.01
    degrees of JAX's end (its error against the rendered truth, 2.3
    degrees after the blackout, is the loop's own, not the port's)."""
    jm, jo, pm, po = blackout
    lost = po.lost.numpy()
    assert lost[BLANK[0]:BLANK[1]].all() and not lost[BLANK[1] + 1:].any(), lost
    after = po.inserted_kf.numpy()[BLANK[1]:]
    assert after.sum() >= 2, po.inserted_kf
    _assert_outputs_close(jo, po)
    valid = np.asarray(jm.kf_valid)
    np.testing.assert_array_equal(pm.kf_valid.numpy(), valid)
    np.testing.assert_allclose(pm.kf_R.numpy()[valid], np.asarray(jm.kf_R)[valid], atol=2e-3)
    np.testing.assert_allclose(pm.kf_t.numpy()[valid], np.asarray(jm.kf_t)[valid], atol=2e-3)
    assert _rot_err_deg(po.R[-1].numpy(), np.asarray(jo.R[-1])) < 0.01


def test_predicted_octave_on_a_power_of_s():
    """PredictScale's ceil on an exact power of s. A camera at the pose
    where a point's statistics were taken sees it at that distance, so
    dmax / dist = s^k up to f32 rounding; the port must take JAX's level
    (f32 log(s)), not the next. test_torch_multiseq_mapping's ground-truth
    seeded map of sequence 1, matched from its keyframe's pose on the next
    frame's keypoints: JAX's matches exactly (the float64 log(s) moved 7
    of ~37)."""
    from orb_slam_tracking_tpu import config as jx_config
    from orb_slam_tracking_tpu.ops.extractor import orb_extract as jx_orb_extract
    from test_torch_multiseq_mapping import CAM, OCFG, TCFG, _jx, _port_map, _scene

    maps, images, R0, t0, K, _ = _scene()
    jm, pm = maps[1], _port_map(maps[1])
    kps = jx_orb_extract(jnp.asarray(images[1, 0]), _jx(OCFG))
    dist = np.linalg.norm(np.asarray(jm.pts) + (R0[1].T @ t0[1])[None], axis=-1)
    dmax = np.asarray(jm.pt_dmax)
    q = np.log(np.where(dmax > 0, dmax / dist, 1.0)) / np.log(OCFG.scale_factor)
    assert (np.asarray(jm.pt_valid) & (dmax > 0) & (np.abs(q - np.round(q)) < 1e-5)).sum() >= 20
    kw = dict(scale_factor=OCFG.scale_factor, n_levels=OCFG.n_levels)
    got = search_by_projection(
        pm.pts, pm.desc, pm.pt_valid, _t(R0[1]), _t(t0[1]), _t(K),
        _t(np.asarray(kps.desc).view(np.int32)), _t(kps.xy), _t(kps.valid),
        TCFG.projection_radius, CFG.matcher, CAM.width, CAM.height, kp_octave=_t(kps.octave),
        pt_normal=pm.pt_normal, pt_dmin=pm.pt_dmin, pt_dmax=pm.pt_dmax, **kw)
    ref = jx_sbp(jm.pts, jm.desc, jm.pt_valid, jnp.asarray(R0[1]), jnp.asarray(t0[1]),
                 jnp.asarray(K), kps.desc, kps.xy, kps.valid, TCFG.projection_radius,
                 jx_config.MatcherConfig(), CAM.width, CAM.height, kp_octave=kps.octave,
                 pt_normal=jm.pt_normal, pt_dmin=jm.pt_dmin, pt_dmax=jm.pt_dmax, **kw)
    assert int(ref.n_matches) > 20
    np.testing.assert_array_equal(got.kp_for_point.numpy(), np.asarray(ref.kp_for_point))
