"""Parity of the port's per-level extractor, Harris ranking and detection
mask with the JAX package, on the CPU.

Same numpy inputs, made from a seed, go through the JAX function and its
port; the image is small (240x180, 4 levels, 300 features) to keep JAX's
compiles short. Exact ops are compared exactly; each tolerance states its
reason.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu import config as jx_config
from orb_slam_tracking_tpu.ops import extractor as jx_extractor
from orb_slam_tracking_tpu.ops.harris import harris_response as jx_harris
from orb_slam_tracking_tpu.utils import synthetic as jx_synthetic
from orb_slam_tracking_tpu_torch.config import CameraConfig, OrbConfig
from orb_slam_tracking_tpu_torch.ops import brief, fast, harris, orientation, pyramid
from orb_slam_tracking_tpu_torch.ops.extractor import ExtractorConstants, orb_extract
from orb_slam_tracking_tpu_torch.types import Keypoints

_H, _W = 180, 240
_CAM = CameraConfig(fx=225.0, fy=225.0, cx=120.0, cy=90.0, width=_W, height=_H)
_EPS = float(np.finfo(np.float32).eps)
_TINY = float(np.finfo(np.float32).tiny)   # the least normal f32


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread, as the other port tests: no spinning against
    the other xdist workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jx(cfg):
    """The JAX package's config with the same fields as the port's."""
    return getattr(jx_config, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _cfg(**kw):
    return OrbConfig(n_features=300, n_levels=4, **kw)


@functools.lru_cache(maxsize=1)
def _frame():
    field = jx_synthetic.CornerField(np.random.default_rng(3), n=400)
    R, t = jx_synthetic.make_trajectory(4, "strafe")[1]
    return jx_synthetic.render_frame(field, _jx(_CAM), R, t).astype(np.float32)


def _half_mask():
    mask = np.zeros((_H, _W), np.float32)
    mask[:, _W // 2:] = 1.0
    return mask


@functools.lru_cache(maxsize=None)
def _jax_levels(score_type, masked):
    """JAX's per-level extraction of the frame, jitted as ``orb_extract`` is.
    The unmasked run passes a mask of ones, which masks nothing: both runs
    then share one compile."""
    mask = _half_mask() if masked else np.ones((_H, _W), np.float32)
    kps = jx_extractor.orb_extract(jnp.asarray(_frame()),
                                   _jx(_cfg(score_type=score_type, use_atlas=False)),
                                   jnp.asarray(mask))
    return {f: np.asarray(getattr(kps, f)) for f in kps._fields}


@functools.lru_cache(maxsize=None)
def _port(score_type, masked, use_atlas):
    mask = torch.from_numpy(_half_mask()) if masked else None
    kps = orb_extract(torch.from_numpy(_frame()),
                      _cfg(score_type=score_type, use_atlas=use_atlas), mask=mask)
    return {f: getattr(kps, f).numpy() for f in kps._fields}


def _harris_terms(padded):
    """The box sums a, b, c of ``harris_response`` in float64 from the
    port's f32 derivative maps, at every interior pixel."""
    p = torch.from_numpy(padded)
    h, w = p.shape[0] - 38, p.shape[1] - 38

    def sl(dy, dx):
        return p[19 + dy: 19 + dy + h, 19 + dx: 19 + dx + w].double()

    ix = sl(0, 1) - sl(0, -1)
    iy = sl(1, 0) - sl(-1, 0)
    return tuple(harris._box_sum(x, 3).numpy() for x in (ix * ix, iy * iy, ix * iy))


def _harris_bound(padded):
    """Per pixel, the bound on the port's Harris response against jitted
    JAX's. XLA on the CPU may contract each product with the add that
    follows into one fused multiply-add, which skips that product's
    rounding (at most one ulp of it). The box sums a, b (sums of squares)
    then move by <= eps * a, eps * b, and c by <= eps * sum|ix iy| <=
    eps * (a + b) / 2; a b, c^2 and k (a + b)^2, each rounded once more,
    move by <= 4 eps a b, 2 eps |c| (a + b) + eps c^2 <= 2 eps (a + b)^2
    and 4 eps k (a + b)^2. So |delta| <= 16 eps s4 (a b + c^2 + (a + b)^2)
    holds with room (s4 the response's scale)."""
    a, b, c = _harris_terms(padded)
    s4 = (1.0 / (4.0 * harris.HARRIS_BLOCK * 255.0)) ** 4
    return 16 * _EPS * s4 * (np.abs(a * b) + c * c + (a + b) ** 2)


@pytest.mark.parametrize("kind", ["rendered", "random"])
def test_harris_response_within_derived_bound(kind):
    img = (_frame() if kind == "rendered"
           else np.floor(np.random.default_rng(1).random((_H, _W)) * 256).astype(np.float32))
    padded = np.pad(img, 19, mode="reflect")
    got = harris.harris_response(torch.from_numpy(padded)).numpy()
    # JAX eager runs the same ops one by one: equal bit for bit, but that XLA
    # flushes subnormal results to zero
    np.testing.assert_array_equal(np.where(np.abs(got) < _TINY, 0.0, got),
                                  np.asarray(jx_harris(jnp.asarray(padded))))
    ref = np.asarray(jax.jit(jx_harris)(jnp.asarray(padded)))
    diff = np.abs(got.astype(np.float64) - ref)
    bound = _harris_bound(padded) + _TINY
    assert (diff <= bound).all(), float((diff / np.maximum(bound, 1e-30)).max())


def _level_shapes():
    shapes = set()
    for h, w in ((480, 640), (480, 752)):
        for hl, wl in OrbConfig(n_levels=8, scale_factor=1.2).level_shapes(h, w):
            shapes.add(((h, w), (hl, wl)))
    rng = np.random.default_rng(5)
    for _ in range(6):
        h, w = (int(v) for v in rng.integers(20, 700, 2))
        shapes.add(((h, w), (int(rng.integers(1, h + 1)), int(rng.integers(1, w + 1)))))
    return sorted(shapes)


@pytest.mark.parametrize("src,dst", _level_shapes())
def test_mask_level_matches_jitted_jax(src, dst):
    """The nearest source row and column of each level pixel are those of
    the jitted ``jax.image.resize(..., "nearest")`` (which multiplies by
    the f32 reciprocal of the size, ops/pyramid._nearest_index), read off
    index ramps; and a random mask is resized to the same bits."""
    (h, w), (hl, wl) = src, dst
    ramp = jax.jit(lambda x: jax.image.resize(x, (hl,), "nearest"))(
        jnp.arange(h, dtype=jnp.float32))
    np.testing.assert_array_equal(pyramid._nearest_index(h, hl, "cpu").numpy(),
                                  np.asarray(ramp).astype(np.int64))
    ramp = jax.jit(lambda x: jax.image.resize(x, (wl,), "nearest"))(
        jnp.arange(w, dtype=jnp.float32))
    np.testing.assert_array_equal(pyramid._nearest_index(w, wl, "cpu").numpy(),
                                  np.asarray(ramp).astype(np.int64))
    mask = (np.random.default_rng(h * w).random((h, w)) < 0.5).astype(np.float32)
    ref = jax.jit(jx_extractor._mask_level, static_argnums=(1, 2))(jnp.asarray(mask), hl, wl)
    np.testing.assert_array_equal(pyramid.mask_level(torch.from_numpy(mask), hl, wl).numpy(),
                                  np.asarray(ref))


def _pairs_within(a_xy, a_resp, b_xy, b_resp, bound_at):
    """Keypoints of one level in one set and not the other, paired by
    response order; each pair's responses must lie within the bound, so
    that only a near-tie moved them."""
    sa = {tuple(v) for v in a_xy}
    sb = {tuple(v) for v in b_xy}
    da = sorted((r, tuple(v)) for v, r in zip(a_xy, a_resp) if tuple(v) not in sb)
    db = sorted((r, tuple(v)) for v, r in zip(b_xy, b_resp) if tuple(v) not in sa)
    assert len(da) == len(db), (da, db)
    for (ra, va), (rb, vb) in zip(da, db):
        assert abs(ra - rb) <= bound_at(va) + bound_at(vb), (va, ra, vb, rb)
    return len(da)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("score_type", ["fast", "harris"])
def test_per_level_matches_jax(score_type, masked):
    """The port's per-level path against JAX's. The port's levels come from
    the f64-derived resize matrices, JAX's per-level path on the CPU from
    ``jax.image.resize`` with f32 weights (test_torch_extract's
    test_resize_levels: <= 5e-3), so FAST scores move by a few 1e-3;
    under Harris, jitted JAX's responses move within the derived bound,
    and the selection may swap keypoints whose values tie within it."""
    ref = _jax_levels(score_type, masked)
    got = _port(score_type, masked, False)
    cfg = _cfg(score_type=score_type)
    levels = pyramid.build_pyramid(torch.from_numpy(_frame()),
                                   ExtractorConstants(_H, _W, cfg, "cpu").resize_mats)
    swapped = 0
    for lvl, padded in enumerate(levels):
        gv = got["valid"] & (got["octave"] == lvl)
        rv = ref["valid"] & (ref["octave"] == lvl)
        scale = cfg.scale_factor ** lvl
        if score_type == "harris":
            bound = _harris_bound(padded.numpy())

            def bound_at(xy, bound=bound, scale=scale):
                x, y = (int(round(v / scale)) for v in xy)
                return float(bound[y, x]) + 2 * _EPS   # + the rounding of h + 1
        else:
            def bound_at(xy):
                return 1e-2
        swapped += _pairs_within(got["xy"][gv], got["response"][gv],
                                 ref["xy"][rv], ref["response"][rv], bound_at)
    assert swapped <= 2, swapped
    same = (got["valid"] == ref["valid"]) & (got["xy"] == ref["xy"]).all(1) & got["valid"]
    assert same.sum() >= got["valid"].sum() - 2 * swapped - 2
    np.testing.assert_array_equal(got["desc"][same], ref["desc"][same].view(np.int32))
    tol = 1e-2 if score_type == "fast" else 1e-6
    np.testing.assert_allclose(got["response"][same], ref["response"][same], atol=tol, rtol=0)
    # jitted JAX fuses the moment adds: angles move by a few 1e-3 degrees
    np.testing.assert_allclose(got["angle_deg"][same], ref["angle_deg"][same], atol=1e-2,
                               rtol=0)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("score_type", ["fast", "harris"])
def test_per_level_identical_to_atlas(score_type, masked):
    """Both of the port's paths read every keypoint's stencils inside its
    level's apron from the same level pixels: identical output."""
    got, ref = _port(score_type, masked, False), _port(score_type, masked, True)
    for f in Keypoints._fields:
        np.testing.assert_array_equal(got[f], ref[f], err_msg=f)


@pytest.mark.parametrize("use_atlas", [True, False])
def test_harris_ranks_fast_corners(use_atlas):
    """test_harris_mask's assertions on the port: Harris keeps FAST's
    detection support and budget, its responses lie in OpenCV's range, and
    it ranks differently from FAST, over the same corners."""
    k_fast, k_har = _port("fast", False, use_atlas), _port("harris", False, use_atlas)
    nf, nh = int(k_fast["valid"].sum()), int(k_har["valid"].sum())
    assert nh >= 0.9 * nf
    r = k_har["response"][k_har["valid"]]
    assert np.all(np.abs(r) < 0.5) and np.all(r > -1.0)
    sf = {tuple(v) for v in np.round(k_fast["xy"][k_fast["valid"]], 1)}
    sh = {tuple(v) for v in np.round(k_har["xy"][k_har["valid"]], 1)}
    assert sf != sh
    assert len(sf & sh) > 0.3 * len(sf)


@pytest.mark.parametrize("use_atlas", [True, False])
def test_detection_mask(use_atlas):
    """test_harris_mask's mask assertions on the port: with the left half
    masked every keypoint lies in the right half, within one coarsest-level
    pixel of nearest-resize rounding; unmasked, the left half has some."""
    cfg = _cfg()
    kps = _port("fast", True, use_atlas)
    xs = kps["xy"][kps["valid"], 0]
    assert kps["valid"].sum() > 50
    assert xs.min() >= _W // 2 - cfg.scale_factor ** (cfg.n_levels - 1)
    k_all = _port("fast", False, use_atlas)
    assert k_all["xy"][k_all["valid"], 0].min() < _W // 2 - 50


def test_per_level_kernels_are_the_plain_versions_on_the_cpu(monkeypatch):
    """On CPU tensors the per-level path takes the three standalone
    wrappers once a level, each running its plain version (no launch)."""
    calls = {"fast_score": 0, "moments_at": 0, "brief_words": 0}
    from orb_slam_tracking_tpu_torch.ops import extractor

    for mod, name in ((fast, "fast_score"), (orientation, "moments_at"),
                      (brief, "brief_words")):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(extractor, name, counted)
    before = (fast.fast_score.launches, orientation.moments_at.launches,
              brief.brief_words.launches)
    orb_extract(torch.from_numpy(_frame()), _cfg(use_atlas=False))
    assert calls == {"fast_score": 4, "moments_at": 4, "brief_words": 4}
    assert before == (fast.fast_score.launches, orientation.moments_at.launches,
                      brief.brief_words.launches)


def test_build_vocabulary_from_frames_matches_jax():
    """A vocabulary trained on a corpus of three frames, pooled descriptors
    subsampled to 600 with the seed's generator: the same tree and idf
    weights, bit for bit (the extraction's descriptors equal JAX's here)."""
    from orb_slam_tracking_tpu.bow import vocabulary as jx_vocabulary
    from orb_slam_tracking_tpu_torch.bow import vocabulary

    field = jx_synthetic.CornerField(np.random.default_rng(9), n=400)
    frames = [jx_synthetic.render_frame(field, _jx(_CAM), R, t).astype(np.float32)
              for R, t in jx_synthetic.make_trajectory(8, "strafe")[::3]]
    cfg = _cfg()
    got = vocabulary.build_vocabulary_from_frames(frames, cfg, k=4, depth=2, seed=1,
                                                  max_descriptors=600, device="cpu")
    ref = jx_vocabulary.build_vocabulary_from_frames(frames, _jx(cfg), k=4, depth=2, seed=1,
                                                     max_descriptors=600)
    assert (got.k, got.depth) == (ref.k, ref.depth)
    for g, r in zip(got.node_desc, ref.node_desc, strict=True):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r).view(np.int32))
    np.testing.assert_array_equal(got.word_weight.numpy(), np.asarray(ref.word_weight))


def test_make_frame_and_features_in_area_match_jax():
    from orb_slam_tracking_tpu.slam import frame as jx_frame
    from orb_slam_tracking_tpu.types import Keypoints as JxKeypoints
    from orb_slam_tracking_tpu_torch.slam import frame

    cam = dataclasses.replace(_CAM, k1=-0.2, p1=1e-3)
    f = frame.make_frame(_frame(), 7, 0.25, _cfg(), cam, device="cpu")
    assert (int(f.frame_id), float(f.timestamp)) == (7, 0.25)
    assert torch.equal(f.R_cw, torch.eye(3)) and torch.equal(f.t_cw, torch.zeros(3))
    ref = jx_frame.make_frame(jnp.asarray(_frame()), 7, 0.25, _jx(_cfg()), _jx(cam))
    np.testing.assert_allclose(f.xy_un.numpy(), np.asarray(ref.xy_un), atol=1e-3, rtol=0)
    kps = JxKeypoints(**{k: jnp.asarray(getattr(f.kps, k).numpy()) for k in Keypoints._fields})
    rng = np.random.default_rng(2)
    for _ in range(8):
        x, y = rng.uniform(0, _W), rng.uniform(0, _H)
        r = float(rng.uniform(5, 60))
        lo, hi = (int(v) for v in rng.integers(-1, 4, 2))
        got = frame.features_in_area(f.kps, f.xy_un, x, y, r, lo, hi).numpy()
        want = jx_frame.features_in_area(kps, jnp.asarray(f.xy_un.numpy()), x, y, r, lo, hi)
        np.testing.assert_array_equal(got, np.asarray(want))
