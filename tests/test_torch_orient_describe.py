"""The one-pass orientation and description (``ops.describe``, "B4f"), on
the CPU.

``orient_describe`` runs its plain chain on CPU tensors: the disc moments
at the keypoints, the angle, the rotated and rounded pattern, the rounded
blurred canvas, the sampler, compare and pack. That chain is held to the
JAX package's ``angles_at(moment_maps)`` and ``descriptors_at``. The CUDA
kernel ``csrc/orient_describe.cu`` cannot run here; the parts of its
algebra that differ in form from the plain chain are mirrored in numpy and
held to it exactly:

* the pattern rotated with separately rounded products and ``rint``,
  truncated to int before the pad is added, then clamped;
* ``rint`` of each sample instead of ``round`` of the whole canvas;
* the descriptor words built as ``__ballot_sync`` builds them.

``chip_smoke.py`` holds the kernel itself to the plain chain on the card,
bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.ops import brief as jx_brief
from orb_slam_tracking_tpu.ops import orientation as jx_orient
from orb_slam_tracking_tpu_torch.ops import brief, describe, orientation, pattern

PAD = pattern.EDGE_THRESHOLD


def _pattern_xy():
    p = pattern.brief_pattern().astype(np.float32)  # [256, 4]: x1, y1, x2, y2
    return torch.from_numpy(np.stack([np.concatenate([p[:, 0], p[:, 2]]),
                                      np.concatenate([p[:, 1], p[:, 3]])]))


def _inputs(rng, h, w, n, integer):
    """A padded canvas and a blurred canvas [h + 2 PAD, w + 2 PAD], and n
    keypoints anywhere in the interior: (yc, xc) disc centres and xy."""
    shape = (h + 2 * PAD, w + 2 * PAD)
    canvas = rng.random(shape) * 255
    canvas = (np.floor(canvas) if integer else canvas).astype(np.float32)
    blurred = (rng.random(shape) * 255).astype(np.float32)
    x = rng.integers(0, w, n)
    y = rng.integers(0, h, n)
    xy = np.stack([x, y], -1).astype(np.float32)
    return canvas, blurred, (y + PAD).astype(np.int32), (x + PAD).astype(np.int32), xy


@pytest.mark.parametrize("integer", [True, False])
@pytest.mark.parametrize("n", [300, 37])
def test_orient_describe_reference_matches_jax(rng, integer, n):
    canvas, blurred, yc, xc, xy = _inputs(rng, 90, 130, n, integer)
    m10, m01 = jx_orient.moment_maps(jnp.asarray(canvas))
    ref_angle = np.asarray(jx_orient.angles_at(m10, m01, jnp.asarray(xy)))
    angle, desc = describe.orient_describe(
        torch.from_numpy(canvas), torch.from_numpy(blurred), torch.from_numpy(yc),
        torch.from_numpy(xc), torch.from_numpy(xy), _pattern_xy(), pattern.umax_table())
    assert angle.shape == (n,) and angle.dtype == torch.float32
    assert desc.shape == (n, 8) and desc.dtype == torch.int32
    # XLA's and PyTorch's atan2 differ by one f32 ulp on some inputs
    # (tests/test_torch_extract.py::test_angles_at)
    np.testing.assert_allclose(angle.numpy(), ref_angle, atol=1e-4, rtol=0)
    ref_desc = np.asarray(jx_brief.descriptors_at(jnp.asarray(blurred), jnp.asarray(xy),
                                                  jnp.asarray(ref_angle)))
    np.testing.assert_array_equal(desc.numpy(), ref_desc.view(np.int32))
    assert describe.orient_describe.launches == 0


def _f32(a):
    return np.asarray(a, dtype=np.float32)


def _kernel_coords(xy, angle, pattern_xy, hp, wp, fused=False):
    """The kernel's coordinate algebra in numpy f32, one rounding per
    operation (numpy never contracts to an FMA): theta by torch's deg2rad
    multiplier; cos/sin as the plain chain takes them; rint of each
    rotated coordinate; truncation of xy + r to int, then + pad; clamp.
    ``fused`` keeps the first product exact, as an FMA would."""
    theta = _f32(angle) * np.float32(0.017453292519943295)
    t = torch.from_numpy(theta)
    ca, sa = torch.cos(t).numpy()[:, None], torch.sin(t).numpy()[:, None]
    px, py = pattern_xy[0][None, :], pattern_xy[1][None, :]
    first = (lambda a, b: a.astype(np.float64) * b) if fused else (lambda a, b: _f32(a * b))
    rx = np.rint(_f32(first(px, ca) - _f32(py * sa)))
    ry = np.rint(_f32(first(px, sa) + _f32(py * ca)))
    sx = np.clip(_f32(xy[:, 0:1] + rx).astype(np.int32) + PAD, 0, wp - 1)
    sy = np.clip(_f32(xy[:, 1:2] + ry).astype(np.int32) + PAD, 0, hp - 1)
    return sy, sx


def _half_crossings():
    """(angles, px, py): f32 angles within a few ulps of where an integer
    pattern point's rotated x lands on k + .5, and that point, kept where
    an FMA and separately rounded products round it differently."""
    p = np.arange(-13, 14, dtype=np.float64)
    px, py, k = (a.ravel() for a in np.meshgrid(p, p, np.arange(-14, 14) + 0.5))
    r = np.hypot(px, py)
    ok = np.abs(k) < r
    px, py, k, r = px[ok], py[ok], k[ok], r[ok]
    phi = np.arctan2(py, px)
    deg = np.concatenate([np.degrees(np.arccos(k / r) - phi),
                          np.degrees(-np.arccos(k / r) - phi)]) % 360
    px, py = np.tile(px, 2), np.tile(py, 2)
    steps = np.arange(-8, 9, dtype=np.int32)
    ang = (_f32(deg)[:, None].view(np.int32) + steps).view(np.float32).ravel()
    px, py = _f32(np.repeat(px, steps.size)), _f32(np.repeat(py, steps.size))
    t = torch.from_numpy(ang * np.float32(0.017453292519943295))
    ca, sa = torch.cos(t).numpy(), torch.sin(t).numpy()
    separate = np.rint(_f32(px * ca) - _f32(py * sa))
    fma = np.rint(_f32(px.astype(np.float64) * ca - _f32(py * sa)))
    hit = separate != fma
    return ang[hit], px[hit], py[hit]


def test_rotation_with_separate_rounding_equals_brief_coords(rng):
    """Angles at multiples of 90 degrees (where f32 cos/sin leave a ~4e-8
    remainder), angles and integer pattern points whose rotation lands
    within one rounding of .5 (where an FMA would move the coordinate to
    the next integer), half-integer points (on .5 exactly at 0 and 180
    degrees: rint rounds half to even) and random ones; keypoints past the
    border, so the clamp acts. The separately rounded form equals
    ``brief_coords``; the fused form does not."""
    ang_x, px_x, py_x = _half_crossings()
    pick = rng.choice(ang_x.size, 96, replace=False)
    half = np.arange(-12.5, 13, 1.0)
    fill = 512 - half.size - pick.size
    px = np.concatenate([half, px_x[pick], rng.integers(-13, 14, fill)]).astype(np.float32)
    py = np.concatenate([half[::-1], py_x[pick], rng.integers(-13, 14, fill)]).astype(np.float32)
    pattern_xy = np.stack([px, py])
    angles = np.concatenate([np.arange(0, 360, 90), ang_x[pick],
                             rng.random(40) * 360]).astype(np.float32)
    n = angles.size
    xy = np.stack([rng.integers(-25, 85, n), rng.integers(-25, 65, n)], -1).astype(np.float32)
    hp, wp = 40 + 2 * PAD, 60 + 2 * PAD
    sy, sx = brief.brief_coords(torch.from_numpy(xy), torch.from_numpy(angles),
                                torch.from_numpy(pattern_xy), hp, wp)
    ky, kx = _kernel_coords(xy, angles, pattern_xy, hp, wp)
    np.testing.assert_array_equal(sy.numpy(), ky)
    np.testing.assert_array_equal(sx.numpy(), kx)
    # the clamp was exercised on both sides of both axes
    assert all((k == 0).any() and (k == m - 1).any() for k, m in ((kx, wp), (ky, hp)))
    assert (_kernel_coords(xy, angles, pattern_xy, hp, wp, fused=True)[1] != kx).any()


def _ballot_words(bits):
    """Words as the kernel's ballots build them: word j holds lane k's
    predicate for pair j*32 + k at bit k."""
    n = bits.shape[0]
    words = np.zeros((n, 8), np.uint32)
    for j in range(8):
        for k in range(32):
            words[:, j] |= bits[:, j * 32 + k].astype(np.uint32) << np.uint32(k)
    return words.view(np.int32)


def test_kernel_algebra_equals_the_plain_chain(rng):
    """The kernel's sampling in numpy (its coordinates, ``rint`` of each
    sample, ballot words) against the plain chain's descriptors, which
    round the whole canvas first and pack with ``pack_bits``."""
    canvas, blurred, yc, xc, xy = _inputs(rng, 70, 110, 120, integer=False)
    pattern_xy = _pattern_xy()
    angle, desc = describe.orient_describe_reference(
        torch.from_numpy(canvas), torch.from_numpy(blurred), torch.from_numpy(yc),
        torch.from_numpy(xc), torch.from_numpy(xy), pattern_xy, pattern.umax_table())
    sy, sx = _kernel_coords(xy, angle.numpy(), pattern_xy.numpy(), *blurred.shape)
    samples = np.rint(blurred[sy, sx])
    assert (samples == np.rint(blurred)[sy, sx]).all()
    np.testing.assert_array_equal(_ballot_words(samples[:, :256] < samples[:, 256:]),
                                  desc.numpy())


def test_ballot_word_order_equals_pack_bits(rng):
    bits = rng.random((50, 256)) < 0.5
    bits[0] = True  # the sign bit of every word
    got = brief.pack_bits(torch.from_numpy(bits)).numpy()
    np.testing.assert_array_equal(_ballot_words(bits), got)


def test_orient_describe_angles_equal_moments_at(rng):
    """The angle is ``angles_from_moments`` of the per-keypoint moments, so
    the extractor's angles are those of the standalone B4 path."""
    canvas, blurred, yc, xc, xy = _inputs(rng, 60, 80, 64, integer=True)
    c, b = torch.from_numpy(canvas), torch.from_numpy(blurred)
    angle, _ = describe.orient_describe(c, b, torch.from_numpy(yc), torch.from_numpy(xc),
                                        torch.from_numpy(xy), _pattern_xy(),
                                        pattern.umax_table())
    m = orientation.moments_at(c, torch.from_numpy(yc), torch.from_numpy(xc),
                               pattern.umax_table())
    assert torch.equal(angle, orientation.angles_from_moments(*m))
