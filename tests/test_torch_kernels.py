"""Parity of the port's kernel modules with the JAX package, on the CPU.

On CPU tensors each wrapper of the port runs its plain PyTorch version;
these tests hold that version to the JAX package's XLA reference and to
the Pallas kernel run in interpret mode, exactly. The CUDA kernels
themselves are compared with the same plain versions on the card by
``chip_smoke.py``.
"""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.ops import brief as jx_brief
from orb_slam_tracking_tpu.ops import fast as jx_fast
from orb_slam_tracking_tpu.ops import hamming as jx_hamming
from orb_slam_tracking_tpu.ops import pattern as jx_pattern
from orb_slam_tracking_tpu.ops import orientation as jx_orientation
from orb_slam_tracking_tpu.ops.pallas_kernels import (
    brief_sample_pallas,
    fast_score_pallas,
    hamming_matrix_pallas,
    moments_at_pallas,
)
from orb_slam_tracking_tpu.ops.pyramid import reflect_pad as jx_reflect_pad
from orb_slam_tracking_tpu_torch import kernels
from orb_slam_tracking_tpu_torch.ops import brief, describe, fast, hamming, orientation, pattern
from orb_slam_tracking_tpu_torch.optim import pose_opt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _corner_image(rng, h, w):
    img = (rng.random((h, w)) * 255).astype(np.float32)
    img[20:28, 30:38] = 250.0
    img[h - 30: h - 20, w - 40: w - 30] = 5.0
    return img


@pytest.mark.parametrize("shape", [(100, 150), (77, 131)])
def test_fast_score_matches_jax_and_pallas(rng, shape):
    pad = pattern.EDGE_THRESHOLD
    padded = np.array(
        jx_reflect_pad(jnp.asarray(_corner_image(rng, *shape)), pad))
    ref = np.asarray(jx_fast.fast_score(jnp.asarray(padded), pad))
    pal = np.asarray(fast_score_pallas(jnp.asarray(padded), pad, interpret=True))
    got = fast.fast_score(torch.from_numpy(padded), pad).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)


def test_fast_score_integer_image_ties(rng):
    """Integer images give many equal scores; min/max stay exact."""
    img = np.floor(rng.random((60, 90)) * 4).astype(np.float32) * 60.0
    padded = np.pad(img, 19, mode="reflect")
    ref = np.asarray(jx_fast.fast_score(jnp.asarray(padded), 19))
    got = fast.fast_score_reference(torch.from_numpy(padded), 19).numpy()
    np.testing.assert_array_equal(got, ref)


def _brief_inputs(rng, n):
    img = np.floor(rng.random((518, 678)) * 256).astype(np.float32)
    cy = rng.integers(35, 480, n)
    cx = rng.integers(35, 640, n)
    sy = (cy[:, None] + rng.integers(-19, 20, (n, 512))).astype(np.int32)
    sx = (cx[:, None] + rng.integers(-19, 20, (n, 512))).astype(np.int32)
    return img, sy, sx


@pytest.mark.parametrize("n", [100, 33])
def test_brief_words_matches_jax_and_pallas(rng, n):
    img, sy, sx = _brief_inputs(rng, n)
    gathered = img.reshape(-1)[sy * img.shape[1] + sx]
    ref = np.asarray(jx_brief.pack_bits(
        jnp.asarray(gathered[:, :256] < gathered[:, 256:])))
    sampled = brief_sample_pallas(jnp.asarray(img), jnp.asarray(sy),
                                  jnp.asarray(sx), interpret=True,
                                  integer_values=True)
    pal = np.asarray(jx_brief.pack_bits(sampled[:, :256] < sampled[:, 256:]))
    got = brief.brief_words(torch.from_numpy(img), torch.from_numpy(sy),
                            torch.from_numpy(sx)).numpy()
    assert got.dtype == np.int32 and got.shape == (n, 8)
    np.testing.assert_array_equal(got, ref.view(np.int32))
    np.testing.assert_array_equal(got, pal.view(np.int32))


def test_brief_words_clamps_coordinates(rng):
    img = np.floor(rng.random((40, 50)) * 256).astype(np.float32)
    sy = rng.integers(-5, 45, (7, 512)).astype(np.int32)
    sx = rng.integers(-5, 55, (7, 512)).astype(np.int32)
    got = brief.brief_words_reference(torch.from_numpy(img), torch.from_numpy(sy),
                                      torch.from_numpy(sx))
    inside = brief.brief_words_reference(
        torch.from_numpy(img), torch.from_numpy(np.clip(sy, 0, 39)),
        torch.from_numpy(np.clip(sx, 0, 49)))
    assert torch.equal(got, inside)


def test_pack_bits_matches_jax(rng):
    bits = rng.random((9, 256)) < 0.5
    ref = np.asarray(jx_brief.pack_bits(jnp.asarray(bits)))
    got = brief.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(got, ref.view(np.int32))


@pytest.mark.parametrize("shape", [(256, 128), (128, 256)])
def test_hamming_matrix_matches_jax_and_pallas(rng, shape):
    d1 = rng.integers(0, 2**32, (shape[0], 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (shape[1], 8), dtype=np.uint32)
    ref = np.asarray(jx_hamming.hamming_matrix(jnp.asarray(d1), jnp.asarray(d2)))
    pal = np.asarray(hamming_matrix_pallas(jnp.asarray(d1), jnp.asarray(d2),
                                           interpret=True))
    got = hamming.hamming_matrix(torch.from_numpy(d1.view(np.int32)),
                                 torch.from_numpy(d2.view(np.int32))).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pal)


def test_hamming_matrix_ragged_shape(rng):
    """Shapes the Pallas kernel refuses (not multiples of 128)."""
    d1 = rng.integers(0, 2**32, (37, 8), dtype=np.uint32)
    d2 = rng.integers(0, 2**32, (53, 8), dtype=np.uint32)
    ref = np.asarray(jx_hamming.hamming_matrix_xor(jnp.asarray(d1), jnp.asarray(d2)))
    got = hamming.hamming_matrix(torch.from_numpy(d1.view(np.int32)),
                                 torch.from_numpy(d2.view(np.int32))).numpy()
    np.testing.assert_array_equal(got, ref)
    assert got.min() >= 0 and got.max() <= 256


@pytest.mark.parametrize("shape,n", [((200, 384), 96), ((120, 256), 37)])
def test_moments_at_matches_jax_and_pallas(rng, shape, n):
    """The shapes of the JAX package's own moments tests, N not a multiple
    of the Pallas kernel's group of 16 included. The Pallas kernel sums the
    masked disc in another order: held to its own tolerance, 1e-5 x
    (max |m10| + 1). The dense JAX maps (the eager adds the port repeats)
    are matched exactly."""
    canvas = (rng.random(shape) * 255).astype(np.float32)
    pad = pattern.EDGE_THRESHOLD
    r10, r01 = (np.asarray(m) for m in jx_orientation.moment_maps(jnp.asarray(canvas), pad))
    ys = rng.integers(0, r10.shape[0], n).astype(np.int32)
    xs = rng.integers(0, r10.shape[1], n).astype(np.int32)
    p10, p01 = (np.asarray(m) for m in moments_at_pallas(
        jnp.asarray(canvas), jnp.asarray(ys + pad), jnp.asarray(xs + pad), interpret=True))
    g10, g01 = orientation.moments_at(torch.from_numpy(canvas), torch.from_numpy(ys + pad),
                                      torch.from_numpy(xs + pad), pattern.umax_table())
    assert g10.shape == g01.shape == (n,) and g10.dtype == torch.float32
    scale = np.abs(r10[ys, xs]).max() + 1.0
    np.testing.assert_allclose(g10.numpy(), p10, atol=1e-5 * scale, rtol=0)
    np.testing.assert_allclose(g01.numpy(), p01, atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(g10.numpy(), r10[ys, xs])
    np.testing.assert_array_equal(g01.numpy(), r01[ys, xs])


def test_moments_at_clamps_reads(rng):
    canvas = torch.from_numpy((rng.random((40, 50)) * 255).astype(np.float32))
    yc = torch.tensor([0, 39, 5, 20], dtype=torch.int32)
    xc = torch.tensor([0, 49, 45, 2], dtype=torch.int32)
    got = orientation.moments_at_reference(canvas, yc, xc, pattern.umax_table())
    big = torch.nn.functional.pad(canvas[None, None], (15, 15, 15, 15),
                                  mode="replicate")[0, 0]
    ref = orientation.moments_at_reference(big, yc + 15, xc + 15, pattern.umax_table())
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def test_pattern_and_umax_match_jax():
    np.testing.assert_array_equal(pattern.brief_pattern(), jx_pattern.brief_pattern())
    np.testing.assert_array_equal(pattern.umax_table(), jx_pattern.umax_table())
    assert pattern.umax_table().dtype == np.int32
    assert (pattern.EDGE_THRESHOLD, pattern.HALF_PATCH_SIZE, pattern.PATCH_SIZE) == (
        jx_pattern.EDGE_THRESHOLD, jx_pattern.HALF_PATCH_SIZE, jx_pattern.PATCH_SIZE)


def test_launch_counters_stay_zero_on_cpu(rng):
    img, sy, sx = _brief_inputs(rng, 4)
    fast.fast_score(torch.from_numpy(img), 19)
    brief.brief_words(torch.from_numpy(img), torch.from_numpy(sy), torch.from_numpy(sx))
    d = torch.from_numpy(rng.integers(-2**31, 2**31, (5, 8)).astype(np.int32))
    hamming.hamming_matrix(d, d)
    yx = torch.full((3,), 30, dtype=torch.int32)
    orientation.moments_at(torch.from_numpy(img), yx, yx, pattern.umax_table())
    xy = torch.full((3, 2), 11.0)
    describe.orient_describe(torch.from_numpy(img), torch.from_numpy(img), yx, yx, xy,
                             torch.zeros((2, 512)), pattern.umax_table())
    eye = torch.eye(3)
    pose_opt.optimize_pose(eye, torch.zeros(3), torch.ones((4, 3)), torch.zeros((4, 2)),
                           torch.ones(4), torch.ones(4, dtype=torch.bool), eye, rounds=1,
                           iters_per_round=1)
    assert fast.fast_score.launches == 0
    assert brief.brief_words.launches == 0
    assert hamming.hamming_matrix.launches == 0
    assert orientation.moments_at.launches == 0
    assert describe.orient_describe.launches == 0
    assert pose_opt.optimize_pose.launches == 0


@pytest.mark.parametrize("call", ["fast", "brief", "hamming", "hamming_gated", "moments",
                                  "orient_describe", "pose_lm"])
def test_wrappers_refuse_non_cpu_non_cuda_tensors(call):
    """Only a CPU tensor may take the plain version; any other device goes
    to the kernel's checks, which refuse it."""
    img = torch.empty((60, 60), device="meta")
    coords = torch.empty((3, 512), dtype=torch.int32, device="meta")
    desc = torch.empty((3, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        if call == "fast":
            fast.fast_score(img, 19)
        elif call == "brief":
            brief.brief_words(img, coords, coords)
        elif call == "moments":
            yx = torch.empty((3,), dtype=torch.int32, device="meta")
            orientation.moments_at(img, yx, yx, pattern.umax_table())
        elif call == "orient_describe":
            yx = torch.empty((3,), dtype=torch.int32, device="meta")
            xy = torch.empty((3, 2), device="meta")
            pat = torch.empty((2, 512), device="meta")
            describe.orient_describe(img, img, yx, yx, xy, pat, pattern.umax_table())
        elif call == "hamming_gated":
            f = torch.empty((3,), device="meta")
            b = torch.empty((3,), dtype=torch.bool, device="meta")
            i = torch.empty((3,), dtype=torch.int32, device="meta")
            xy = torch.empty((3, 2), device="meta")
            hamming.hamming_gated_min(desc, desc, xy, f, b, i, i, b, xy, f, i, b)
        elif call == "pose_lm":
            m = torch.empty((3, 3), device="meta")
            pose_opt.optimize_pose(m, torch.empty((3,), device="meta"),
                                   torch.empty((5, 3), device="meta"),
                                   torch.empty((5, 2), device="meta"),
                                   torch.empty((5,), device="meta"),
                                   torch.empty((5,), dtype=torch.bool, device="meta"), m)
        else:
            hamming.hamming_matrix(desc, desc)


def test_kernel_build_is_keyed_by_sources_and_needs_nvcc(monkeypatch, tmp_path):
    d = kernels.build_dir()
    assert d.parent == kernels.BUILD_ROOT
    assert kernels.BUILD_ROOT.parent.name == "build"
    assert {p.name for p in kernels._sources()} >= {
        "fast_score.cu", "brief_words.cu", "hamming_matrix.cu", "moments_at.cu",
        "orient_describe.cu", "disc_moments.cuh", "pose_lm.cu"}
    assert set(kernels._SIGNATURES) == {
        "osltt_fast_score", "osltt_brief_words", "osltt_hamming_matrix",
        "osltt_hamming_gated_min", "osltt_moments_at", "osltt_orient_describe",
        "osltt_pose_lm"}
    assert kernels.SOURCE_FLAGS == {"pose_lm.cu": ("-fmad=false",)}
    monkeypatch.setattr(kernels, "SOURCE_FLAGS", {})
    assert kernels.build_dir() != d  # a source's own flags key the build too
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels._nvcc()


def test_port_imports_no_jax():
    """Every module of the port loads without jax and without the JAX
    package, the two-view initialization slice's, the device loop's, the
    BoW and loop-closing slice's, the file IO and tools, the multi-device
    modes' and the measurement tools and studies among them."""
    code = (
        "import sys, importlib, pkgutil\n"
        "import orb_slam_tracking_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "need = {p.__name__ + '.' + m for m in (\n"
        "    'entry', 'ops.matcher', 'ops.orientation', 'slam.two_view_init',\n"
        "    'geometry.sampling', 'geometry.triangulate', 'geometry.homography',\n"
        "    'geometry.fundamental', 'geometry.twoview', 'slam.device_mapping',\n"
        "    'optim.segment', 'tools.seq_fps', 'tools.profile_step', 'bow.vocabulary',\n"
        "    'bow.database', 'geometry.sim3', 'optim.pose_graph', 'slam.loop_closing',\n"
        "    'utils.loop_world', 'io', 'io.images', 'io.tum', 'io.native_loader',\n"
        "    'ops.harris', 'slam.frame', 'utils.viz', 'utils.profiling',\n"
        "    'tools.eval_tum', 'tools.make_synthetic_tum', 'tools.demo_initialization',\n"
        "    'tools.demo_orb_extractor', 'tools.demo_tracking', 'parallel.distributed',\n"
        "    'parallel.matcher_sharded', 'parallel.ba_sharded', 'parallel.pipeline',\n"
        "    'parallel.multiseq', 'tools.demo_multiseq', 'tools.ba_bench',\n"
        "    'tools.scaling_efficiency', 'tools.bow_match_experiment',\n"
        "    'tools.vocab_recall_study')}\n"
        "assert need <= set(sys.modules), need - set(sys.modules)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'orb_slam_tracking_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
