"""Parity of the port's ORB extraction with the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
port. Exact ops are compared exactly; each tolerance states its reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.ops import atlas as jx_atlas
from orb_slam_tracking_tpu.ops import orientation as jx_orient
from orb_slam_tracking_tpu.ops import pyramid as jx_pyramid
from orb_slam_tracking_tpu.ops import select as jx_select
from orb_slam_tracking_tpu.ops.extractor import orb_extract as jx_orb_extract
from orb_slam_tracking_tpu.utils import synthetic as jx_synthetic
from orb_slam_tracking_tpu_torch.config import CameraConfig, OrbConfig
from orb_slam_tracking_tpu_torch.ops import atlas, describe, orientation, pyramid, select
from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract
from orb_slam_tracking_tpu_torch.ops.fast import cell_reduce_max, detect_from_score
from orb_slam_tracking_tpu_torch.ops.pattern import umax_table
from orb_slam_tracking_tpu_torch.types import Keypoints
from orb_slam_tracking_tpu_torch.utils import synthetic

_CFG = OrbConfig(n_features=300, n_levels=4)
_H, _W = 240, 320
_CAM = CameraConfig(fx=225.0, fy=225.0, cx=160.0, cy=120.0, width=_W, height=_H)


def _jx(cfg):
    """The JAX package's config with the same fields as the port's."""
    return getattr(jx_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


@functools.lru_cache(maxsize=1)
def _rendered():
    field = jx_synthetic.CornerField(np.random.default_rng(7), n=500)
    R, t = jx_synthetic.make_trajectory(16, "strafe")[0]
    return jx_synthetic.render_frame(field, _jx(_CAM), R, t).astype(np.float32)


def test_synthetic_scene_matches_jax():
    field = synthetic.CornerField(np.random.default_rng(7), n=200)
    ref = jx_synthetic.CornerField(np.random.default_rng(7), n=200)
    for f in ("pts", "size_m", "blob_off", "blob_amp", "blob_sig"):
        np.testing.assert_array_equal(getattr(field, f), getattr(ref, f), err_msg=f)
    poses = synthetic.make_trajectory(16, "strafe")
    ref_poses = jx_synthetic.make_trajectory(16, "strafe")
    for (R, t), (jR, jt) in zip(poses, ref_poses, strict=True):
        np.testing.assert_array_equal(R, jR)
        np.testing.assert_array_equal(t, jt)
    for f in (0, 9):
        np.testing.assert_array_equal(
            synthetic.render_frame(field, _CAM, *poses[f]),
            jx_synthetic.render_frame(ref, _jx(_CAM), *ref_poses[f]))
    # every mode is ported now (tests/test_torch_io.py holds them all equal);
    # an unknown one raises, as in the JAX package
    with pytest.raises(ValueError, match="spiral"):
        synthetic.make_trajectory(4, "spiral")


def _image(kind):
    if kind == "rendered":
        return _rendered()
    return np.floor(np.random.default_rng(1).random((_H, _W)) * 256).astype(np.float32)


@pytest.mark.parametrize("pad", [3, 19])
def test_reflect_pad_exact(rng, pad):
    img = rng.random((41, 57)).astype(np.float32)
    ref = np.asarray(jx_pyramid.reflect_pad(jnp.asarray(img), pad))
    np.testing.assert_array_equal(pyramid.reflect_pad(torch.from_numpy(img), pad).numpy(), ref)


def test_gauss_taps_exact():
    np.testing.assert_array_equal(pyramid.gauss_taps(device="cpu").numpy(),
                                  np.asarray(jx_pyramid._gauss_kernel_1d(7, 2.0)))


@pytest.mark.parametrize("integer", [True, False])
def test_gaussian_blur_exact(rng, integer):
    img = rng.random((73, 101)) * 255
    img = (np.floor(img) if integer else img).astype(np.float32)
    ref = np.asarray(jx_pyramid.gaussian_blur(jnp.asarray(img)))
    got = pyramid.gaussian_blur(torch.from_numpy(img), pyramid.gauss_taps(device="cpu"))
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("n_in,n_out", [(480, 400), (640, 533), (400, 333), (13, 13)])
def test_resize_matrix_exact(n_in, n_out):
    np.testing.assert_array_equal(pyramid.resize_matrix(n_in, n_out),
                                  jx_pyramid._resize_matrix(n_in, n_out))


def test_resize_levels(rng):
    img = (rng.random((120, 200)) * 255).astype(np.float32)
    mh, mw = pyramid.resize_matrix(120, 100), pyramid.resize_matrix(200, 167)
    got = pyramid.resize(torch.from_numpy(img), torch.tensor(mh),
                         torch.tensor(mw)).numpy()
    # the JAX matrix branch with the same matrices: only the f32 summation
    # order of the two products differs
    tpu_branch = np.asarray(jnp.dot(jnp.dot(jnp.asarray(mh), jnp.asarray(img)),
                                    jnp.asarray(mw).T))
    np.testing.assert_allclose(got, tpu_branch, atol=1e-4, rtol=0)
    # jax.image.resize (the JAX CPU branch) computes the triangle weights in
    # f32 from f32 sample positions, off by up to ~n * 6e-8 px: on [0, 255]
    # images that moves levels by up to ~2e-3 gray levels
    cpu_branch = np.asarray(jx_pyramid._resize_bilinear(jnp.asarray(img), (100, 167)))
    np.testing.assert_allclose(got, cpu_branch, atol=5e-3, rtol=0)


@pytest.mark.parametrize("integer", [True, False])
def test_moment_maps_exact(rng, integer):
    img = rng.random((100, 140)) * 255
    img = (np.floor(img) if integer else img).astype(np.float32)
    r10, r01 = jx_orient.moment_maps(jnp.asarray(img))
    g10, g01 = orientation.moment_maps(torch.from_numpy(img), umax_table())
    np.testing.assert_array_equal(g10.numpy(), np.asarray(r10))
    np.testing.assert_array_equal(g01.numpy(), np.asarray(r01))


@pytest.mark.parametrize("integer", [True, False])
def test_moments_at_reference_equals_dense_maps(rng, integer):
    """The per-keypoint plain version performs the dense pass's operations at
    each pixel, in the same order: equal bit for bit."""
    img = rng.random((120, 170)) * 255
    img = torch.from_numpy((np.floor(img) if integer else img).astype(np.float32))
    m10, m01 = orientation.moment_maps(img, umax_table())
    ys = torch.from_numpy(rng.integers(0, m10.shape[0], 300).astype(np.int32))
    xs = torch.from_numpy(rng.integers(0, m10.shape[1], 300).astype(np.int32))
    g10, g01 = orientation.moments_at_reference(img, ys + 19, xs + 19, umax_table())
    np.testing.assert_array_equal(g10.numpy(), m10[ys.long(), xs.long()].numpy())
    np.testing.assert_array_equal(g01.numpy(), m01[ys.long(), xs.long()].numpy())


def test_angles_at(rng):
    img = (rng.random((100, 140)) * 255).astype(np.float32)
    m10, m01 = (np.asarray(m) for m in jx_orient.moment_maps(jnp.asarray(img)))
    xy = np.stack([rng.integers(0, 102, 400), rng.integers(0, 62, 400)], -1).astype(np.float32)
    ref = np.asarray(jx_orient.angles_at(jnp.asarray(m10), jnp.asarray(m01), jnp.asarray(xy)))
    got = orientation.angles_at(torch.from_numpy(m10), torch.from_numpy(m01),
                                torch.from_numpy(xy)).numpy()
    # XLA's and PyTorch's atan2 differ by one f32 ulp on some inputs; in
    # degrees near 360 that is up to ~3e-5
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)


@pytest.mark.parametrize("cs", [5, 35])
def test_cell_reduce_max_exact(rng, cs):
    x = (rng.random((47, 83)) * 40).astype(np.float32)
    ref = np.asarray(jx_fast_cell(jnp.asarray(x), cs))
    np.testing.assert_array_equal(cell_reduce_max(torch.from_numpy(x), cs).numpy(), ref)


def jx_fast_cell(x, cs):
    from orb_slam_tracking_tpu.ops.fast import _cell_reduce_max

    return _cell_reduce_max(x, cs)


@pytest.mark.parametrize("kind", ["ties", "float"])
def test_select_level_exact(rng, kind):
    if kind == "ties":
        # integer scores on a coarse grid: many cells share their maximum,
        # and within a cell several pixels share it (lower index first)
        score = (rng.integers(0, 4, (70, 95)) * 10).astype(np.float32)
    else:
        score = np.where(rng.random((70, 95)) < 0.05,
                         rng.random((70, 95)) * 80, 0).astype(np.float32)
    xy, resp, valid = jx_select.select_level(jnp.asarray(score), 30, 8)
    gxy, gresp, gvalid = select.select_level(torch.from_numpy(score), 30, 8)
    np.testing.assert_array_equal(gxy.numpy(), np.asarray(xy))
    np.testing.assert_array_equal(gresp.numpy(), np.asarray(resp))
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(valid))


def test_select_level_refuses_small_grid():
    with pytest.raises(ValueError, match="fewer cells"):
        select.select_level(torch.zeros(20, 20), 50, 12)


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_detect_slice_exact(kind):
    img = _image(kind)
    padded = np.pad(img, 19, mode="reflect")
    score = np.asarray(jx_atlas.fast_score(jnp.asarray(padded), 19))
    ref = np.asarray(jx_atlas._detect_slice(jnp.asarray(score), 20, 7, 35))
    got = detect_from_score(torch.from_numpy(score), 20, 7, 35).numpy()
    np.testing.assert_array_equal(got, ref)


def test_atlas_layout_matches_jax():
    for cfg in (_CFG, OrbConfig(n_features=1000)):
        assert tuple(atlas.atlas_layout(480, 640, cfg)) == tuple(
            jx_atlas.atlas_layout(480, 640, _jx(cfg)))


@functools.lru_cache(maxsize=2)
def _jax_extract(kind):
    img = jnp.asarray(_image(kind))
    kps = jx_orb_extract(img, _jx(_CFG))
    canvas = jax.jit(jx_atlas.build_atlas, static_argnums=1)(img, _jx(_CFG))
    return {f: np.asarray(getattr(kps, f)) for f in kps._fields}, np.asarray(canvas)


def _level_sets(xy, octave, valid):
    return [sorted(map(tuple, xy[valid & (octave == lvl)].tolist()))
            for lvl in range(_CFG.n_levels)]


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_extraction_from_jax_canvas(kind):
    ref, canvas = _jax_extract(kind)
    consts = ExtractorConstants(_H, _W, _CFG, device="cpu")
    lay = atlas.atlas_layout(_H, _W, _CFG)
    kps = atlas.extract_from_canvas(torch.from_numpy(canvas), lay, _CFG, consts.gauss,
                                    consts.pattern_xy, consts.umax)
    for f in ("xy", "response", "octave", "size", "valid"):
        np.testing.assert_array_equal(getattr(kps, f).numpy(), ref[f], err_msg=f)
    np.testing.assert_array_equal(kps.desc.numpy(), ref["desc"].view(np.int32))
    # the jitted JAX extractor fuses the ~95 moment adds, which rounds them
    # differently from the same adds run one by one (the port equals JAX's
    # eager moment_maps exactly, test_moment_maps_exact): angles move by a
    # few 1e-3 degrees, far from flipping any rounded BRIEF offset here
    np.testing.assert_allclose(kps.angle_deg.numpy(), ref["angle_deg"], atol=1e-2, rtol=0)


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_kp_moments_extraction_equals_dense(monkeypatch, kind):
    """The extractor takes the moments at the keypoints only (the JAX
    package's ORB_TPU_KP_MOMENTS=1 branch); its output is identical to
    the same extraction with the moments read off the dense maps (the JAX
    package's default branch). On the CPU the moments are those of
    ``orient_describe``'s plain chain, which is patched here."""
    _, canvas = _jax_extract(kind)
    canvas = torch.from_numpy(canvas)
    lay = atlas.atlas_layout(_H, _W, _CFG)
    consts = ExtractorConstants(_H, _W, _CFG, device="cpu")
    img = torch.from_numpy(_image(kind))
    calls = []

    def dense_at(c, yc, xc, umax):
        calls.append(yc.shape[0])
        m10, m01 = orientation.moment_maps(c, umax)
        y, x = yc.long() - 19, xc.long() - 19
        return m10[y, x], m01[y, x]

    def run():
        return (atlas.extract_from_canvas(canvas, lay, _CFG, consts.gauss,
                                          consts.pattern_xy, consts.umax),
                orb_extract(img, _CFG, consts))

    got = run()
    monkeypatch.setattr(describe, "moments_at_reference", dense_at)
    ref = run()
    assert calls == [sum(_CFG.features_per_level())] * 2
    for g, r in zip(got, ref, strict=True):
        for f in Keypoints._fields:
            assert torch.equal(getattr(g, f), getattr(r, f)), f


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_extraction_from_image(kind):
    ref, _ = _jax_extract(kind)
    kps = orb_extract(torch.from_numpy(_image(kind)), _CFG)
    got = {f: getattr(kps, f).numpy() for f in kps._fields}
    assert got["desc"].dtype == np.int32 and got["desc"].shape == (_CFG.max_keypoints, 8)
    assert _level_sets(got["xy"], got["octave"], got["valid"]) == _level_sets(
        ref["xy"], ref["octave"], ref["valid"])
    np.testing.assert_array_equal(got["xy"], ref["xy"])
    np.testing.assert_array_equal(got["valid"], ref["valid"])
    # the port resizes with the f64-derived matrices, JAX on the CPU with
    # f32 weights (test_resize_levels): upper-level scores move by ~3e-3
    np.testing.assert_allclose(got["response"], ref["response"], atol=1e-2, rtol=0)
    valid = got["valid"]
    same = (got["desc"][valid] == ref["desc"][valid].view(np.int32)).all(axis=1)
    assert same.all(), f"{(~same).sum()} of {valid.sum()} descriptors differ"
    assert int(kps.count()) == int(valid.sum())


@pytest.mark.parametrize("cfg,kwargs", [
    (OrbConfig(n_features=100, n_levels=2, use_atlas=False), {}),
    (OrbConfig(n_features=100, n_levels=2, score_type="harris"), {}),
    (OrbConfig(n_features=100, n_levels=2), {"mask": torch.ones(_H, _W)}),
])
def test_unported_extractor_options_raise(cfg, kwargs):
    """The per-level path, Harris ranking and the detection mask, which
    raised until they were ported, now extract (their parity with JAX is in
    tests/test_torch_extract_modes.py); a mask of another shape than the
    image raises."""
    kps = orb_extract(torch.from_numpy(_rendered()), cfg, **kwargs)
    assert kps.desc.shape == (cfg.max_keypoints, 8) and int(kps.count()) > 0
    with pytest.raises(ValueError, match="mask"):
        orb_extract(torch.zeros(_H, _W), cfg, mask=torch.ones(_H, _W + 1))
