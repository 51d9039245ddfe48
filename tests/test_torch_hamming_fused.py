"""The fused Hamming row minima and the redesigned FAST formulation, on the CPU.

``hamming_gated_min`` (both matchers' distance, window and octave gates
and per-row best / second best in one kernel) is held on CPU tensors to an
independent numpy loop over the JAX package's XOR + popcount distances.
The CUDA kernel's own formulations cannot run here; their algebra is
mirrored in numpy / torch and held to the plain versions exactly:

* the key scheme of ``csrc/hamming_matrix.cu``: one int32 key per pair,
  (distance or 257) << 21 | column, a running (best, second) per row by
  integer min/max, and partials merged as best = min, second = min(s1, s2,
  max(b1, b2)) in any split of the columns;
* the shared nine-tap arc extrema of ``csrc/fast_score.cu`` (three-input
  min/max on an int32 order key).

``chip_smoke.py`` holds the kernels themselves to the same plain versions
on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.ops import fast as jx_fast
from orb_slam_tracking_tpu.ops import hamming as jx_hamming
from orb_slam_tracking_tpu.ops.pyramid import reflect_pad as jx_reflect_pad
from orb_slam_tracking_tpu_torch.ops import fast, hamming, matcher, pattern, proj_matcher
from orb_slam_tracking_tpu_torch.ops.hamming import BIG

I32 = np.iinfo(np.int32)


def _inputs(rng, P, N, kind):
    """Seeded gate inputs: ``random`` (spread coordinates, random
    descriptors), ``ties`` (descriptors drawn from 4, integer coordinates on
    the window's edges, radii 0-3) or ``empty`` (most rows see nothing)."""
    if kind == "ties":
        pool = rng.integers(0, 2**32, (4, 8), dtype=np.uint32)
        d1, d2 = pool[rng.integers(0, 4, P)], pool[rng.integers(0, 4, N)]
        uv = rng.integers(0, 16, (P, 2)).astype(np.float32)
        xy = rng.integers(0, 16, (N, 2)).astype(np.float32)
        r_row = rng.integers(0, 4, P).astype(np.float32)
        r_col = rng.integers(0, 4, N).astype(np.float32)
    else:
        d1 = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
        d2 = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
        uv = (rng.random((P, 2)) * 100).astype(np.float32)
        xy = (rng.random((N, 2)) * 100).astype(np.float32)
        scale = 2.0 if kind == "empty" else 30.0
        r_row = (rng.random(P) * scale).astype(np.float32)
        r_col = (rng.random(N) * scale).astype(np.float32)
    use = rng.random(P) < 0.6
    lo = rng.integers(-1, 5, P).astype(np.int32)
    hi = np.where(rng.random(P) < 0.3, I32.max, lo + rng.integers(0, 3, P)).astype(np.int32)
    lo = np.where(rng.random(P) < 0.3, I32.min, lo).astype(np.int32)
    row_ok = rng.random(P) < 0.85
    oct_ = rng.integers(0, 8, N).astype(np.int32)
    col_ok = rng.random(N) < 0.85
    return (d1.view(np.int32), d2.view(np.int32), uv, r_row, use, lo, hi, row_ok,
            xy, r_col, oct_, col_ok)


def _eligible(uv, r_row, use, lo, hi, row_ok, xy, r_col, oct_, col_ok):
    r = np.where(use[:, None], r_row[:, None], r_col[None, :])
    dx = np.abs(uv[:, 0:1] - xy[None, :, 0])
    dy = np.abs(uv[:, 1:2] - xy[None, :, 1])
    return (row_ok[:, None] & col_ok[None, :] & (dx <= r) & (dy <= r)
            & (oct_[None, :] >= lo[:, None]) & (oct_[None, :] <= hi[:, None]))


def _numpy_gated_min(d1, d2, *gates):
    """Row by row over the JAX package's XOR + popcount distances."""
    D = np.asarray(jx_hamming.hamming_matrix_xor(
        jnp.asarray(d1.view(np.uint32)), jnp.asarray(d2.view(np.uint32))))
    vals = np.where(_eligible(*gates), D, BIG)
    best, best_j, second = [], [], []
    for row in vals:
        j = int(np.argmin(row))
        best.append(row[j])
        best_j.append(j)
        second.append(min(np.delete(row, j), default=BIG))
    return [np.asarray(x, np.int32) for x in (best, best_j, second)]


def _torch(args):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in args]


CASES = [("random", 64, 48), ("ragged", 37, 53), ("ties", 70, 41), ("empty", 50, 33),
         ("one_column", 9, 1)]


@pytest.mark.parametrize("kind,P,N", CASES)
def test_gated_min_matches_numpy(rng, kind, P, N):
    args = _inputs(rng, P, N, "random" if kind in ("ragged", "one_column") else kind)
    want = _numpy_gated_min(*args)
    got = hamming.hamming_gated_min(*_torch(args))
    for g, w, name in zip(got, want, ("best", "best_j", "second")):
        assert g.dtype == torch.int32 and g.shape == (P,), name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
    if kind == "ties":  # the case exercises what it is for
        best, _, second = want
        assert ((second == best) & (best < BIG)).any()
        assert (best == BIG).any()
    if kind == "empty":
        assert (want[0] == BIG).sum() > P // 2
        assert (want[1][want[0] == BIG] == 0).all()  # argmin of a constant row


def test_gated_min_reference_is_the_dense_formulation(rng):
    """The plain version is hamming_matrix_reference, the mask and
    amin / argmin, and the least over the other columns."""
    args = _torch(_inputs(rng, 40, 30, "random"))
    D = hamming.hamming_matrix_reference(args[0], args[1])
    elig = torch.from_numpy(_eligible(*(a.numpy() for a in args[2:])))
    Dm = torch.where(elig, D, BIG)
    best, best_j, second = hamming.hamming_gated_min_reference(*args)
    assert torch.equal(best, Dm.amin(1))
    assert torch.equal(best_j.long(), Dm.argmin(1))
    masked = Dm.clone()
    masked[torch.arange(40), best_j.long()] = BIG
    assert torch.equal(second, masked.amin(1))


def _push(kb, ks, key):
    return min(kb, key), min(ks, max(kb, key))


def _merge(b1, s1, b2, s2):
    return min(b1, b2), min(s1, s2, max(b1, b2))


@pytest.mark.parametrize("splits", [1, 3, 8])
def test_kernel_key_scheme_equals_the_plain_version(rng, splits):
    """csrc/hamming_matrix.cu's reduction, emulated: keys per pair, a running
    (best, second) per column split, the splits merged pairwise, decoded."""
    args = _inputs(rng, 24, 45, "ties")
    d1, d2 = args[0], args[1]
    D = np.asarray(jx_hamming.hamming_matrix_xor(
        jnp.asarray(d1.view(np.uint32)), jnp.asarray(d2.view(np.uint32))))
    elig = _eligible(*args[2:])
    empty = I32.max
    want = _numpy_gated_min(*args)
    for i in range(D.shape[0]):
        parts = []
        for cols in np.array_split(rng.permutation(D.shape[1]), splits):
            kb = ks = empty
            for j in sorted(cols):
                kb, ks = _push(kb, ks, (int(D[i, j]) if elig[i, j] else 257) << 21 | int(j))
            parts.append((kb, ks))
        kb, ks = parts[0]
        for ob, os in parts[1:]:
            kb, ks = _merge(kb, ks, ob, os)
        decode = [BIG if kb >> 21 >= 257 else kb >> 21, kb & ((1 << 21) - 1),
                  BIG if ks >> 21 >= 257 else ks >> 21]
        assert decode == [int(w[i]) for w in want], i


def test_gated_min_launches_nothing_on_cpu(rng):
    hamming.hamming_gated_min(*_torch(_inputs(rng, 5, 7, "random")))
    assert hamming.hamming_gated_min.launches == 0
    assert hamming.hamming_matrix.launches == 0


@pytest.mark.parametrize("module,name", [(proj_matcher, "search_by_projection"),
                                         (matcher, "search_for_initialization")])
def test_matchers_take_the_fused_min(module, name, rng, monkeypatch):
    """Both matchers reach the distances only through hamming_gated_min: a
    call makes one call of it and none of the all-pairs hamming_matrix
    (which ops.matcher imports for search_for_triangulation)."""
    assert module.hamming_gated_min is hamming.hamming_gated_min
    calls = []

    def gated(*args):
        calls.append(args)
        return hamming.hamming_gated_min(*args)

    def no_matrix(*args):
        raise AssertionError(f"{name} called hamming_matrix")

    monkeypatch.setattr(module, "hamming_gated_min", gated)
    monkeypatch.setattr(module, "hamming_matrix", no_matrix, raising=False)
    P, N = 40, 30
    desc = torch.tensor(rng.integers(-2**31, 2**31, (P + N, 8)), dtype=torch.int32)
    xy = torch.tensor(rng.uniform(0, 100, (P + N, 2)), dtype=torch.float32)
    octave = torch.zeros(P + N, dtype=torch.int32)
    angle = torch.tensor(rng.uniform(0, 360, P + N), dtype=torch.float32)
    valid = torch.ones(P + N, dtype=torch.bool)
    cfg = matcher.MatcherConfig()
    if module is matcher:
        module.search_for_initialization(desc[:P], xy[:P], octave[:P], angle[:P], valid[:P],
                                         desc[P:], xy[P:], octave[P:], angle[P:], valid[P:],
                                         cfg)
    else:
        pts = torch.tensor(rng.uniform(-1, 1, (P, 3)) + [0, 0, 4], dtype=torch.float32)
        K = torch.tensor([[100.0, 0, 50], [0, 100, 50], [0, 0, 1]])
        module.search_by_projection(pts, desc[:P], valid[:P], torch.eye(3), torch.zeros(3), K,
                                    desc[P:], xy[P:], valid[P:], 10.0, cfg, 100, 100,
                                    kp_octave=octave[P:], scale_factor=1.2,
                                    pt_normal=torch.zeros(P, 3), pt_dmin=torch.zeros(P),
                                    pt_dmax=torch.zeros(P), n_levels=8)
    assert len(calls) == 1


def _order_key(x):
    """csrc/fast_score.cu's order_key: f32 bits <-> int32 of the same order."""
    return x ^ ((x >> 31) & 0x7FFFFFFF)


def _arc_score(d):
    """csrc/fast_score.cu's arc_score over [16, ...] ring differences."""
    k = _order_key(d.view(torch.int32))

    def ext(f):
        m3 = f(f(k, torch.roll(k, -1, 0)), torch.roll(k, -2, 0))
        return f(f(m3, torch.roll(m3, -3, 0)), torch.roll(m3, -6, 0))  # the nine-tap arc
    bright = _order_key(ext(torch.minimum).amax(0)).view(torch.float32)
    dark = _order_key(ext(torch.maximum).amin(0)).view(torch.float32)
    return torch.maximum(bright, -dark)


@pytest.mark.parametrize("kind", ["random", "integer", "signed_zero", "flat", "checker",
                                  "signed"])
def test_shared_arc_extrema_equal_fast_score(rng, kind):
    img = rng.random((50, 70)) * 255
    if kind in ("integer", "signed_zero"):  # many equal differences: min/max ties
        img = np.floor(img / 64) * 64
    if kind == "signed_zero":  # -0 pixels: -0 differences, zero scores
        img[img == 0] = -0.0
    if kind == "flat":  # every difference +0: every score 0
        img = np.full_like(img, 17.0)
    if kind == "checker":  # two values: every arc ties, scores of both signs
        img = np.where(np.add.outer(np.arange(50) // 2, np.arange(70) // 3) % 2, 200.0, 10.0)
    if kind == "signed":  # negative and positive pixels: keys of both signs
        img = img * 2 - 255
    pad = pattern.EDGE_THRESHOLD
    padded = np.array(jx_reflect_pad(jnp.asarray(img.astype(np.float32)), pad))
    t = torch.from_numpy(padded)
    h, w = img.shape
    c = t[pad: pad + h, pad: pad + w]
    d = torch.stack([t[pad + dy: pad + dy + h, pad + dx: pad + dx + w]
                     for dx, dy in fast.RING_OFFSETS]) - c
    got = _arc_score(d)
    assert torch.equal(got, fast.fast_score_reference(t, pad))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jx_fast.fast_score(jnp.asarray(padded), pad)))
