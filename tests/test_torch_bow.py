"""Parity of the port's BoW vocabulary, keyframe database and
vocabulary-restricted matcher with the JAX package, on the CPU: the same
seeded numpy descriptors go through both, files written by either are
read by the other, and each tolerance states its reason."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu.bow import database as jx_db
from orb_slam_tracking_tpu.bow import vocabulary as jx_voc
from orb_slam_tracking_tpu.ops import matcher as jx_matcher
from orb_slam_tracking_tpu_torch.bow import database, vocabulary
from orb_slam_tracking_tpu_torch.ops.matcher import match_descriptors_bow
from orb_slam_tracking_tpu_torch.slam.tracker import BUNDLED_VOCABULARIES
from test_bow import _noisy


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Small tensors: one intra-op thread is as fast, and keeps this file's
    worker from spinning against the others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _i32(d):
    return torch.tensor(np.ascontiguousarray(d, np.uint32).view(np.int32))


def _corpus(rng, n_centers=20, per=30):
    centers = rng.integers(0, 2**32, (n_centers, 8), dtype=np.uint32)
    return centers, np.concatenate([_noisy(rng, c, per) for c in centers])


def _port_of(voc) -> vocabulary.Vocabulary:
    return vocabulary.Vocabulary(tuple(_i32(np.asarray(d)) for d in voc.node_desc),
                                 torch.tensor(np.asarray(voc.word_weight)), voc.k, voc.depth)


def _assert_vocab_equal(got, ref):
    assert (got.k, got.depth) == (ref.k, ref.depth)
    for a, b in zip(got.node_desc, ref.node_desc):
        np.testing.assert_array_equal(a.numpy().view(np.uint32), np.asarray(b))
    np.testing.assert_array_equal(got.word_weight.numpy(), np.asarray(ref.word_weight))


def _assert_transform_equal(voc_p, voc_j, desc, valid):
    """Words exact; the BoW vector within 1e-6 absolute (L1-normalized f32
    sums of the same weights, taken in another order)."""
    wj, bj = jx_voc.transform(voc_j, jnp.asarray(desc), jnp.asarray(valid))
    wp, bp = vocabulary.transform(voc_p, _i32(desc), torch.tensor(valid))
    np.testing.assert_array_equal(wp.numpy(), np.asarray(wj))
    np.testing.assert_allclose(bp.numpy(), np.asarray(bj), atol=1e-6)
    return wp, bp


@pytest.mark.parametrize("k,depth,seed", [(5, 3, 0), (4, 2, 2), (10, 2, 7)])
def test_build_vocabulary_equals_jax(rng, k, depth, seed):
    """The numpy training copied bit for bit: the same tree and weights for
    one seed (including nodes with fewer training descriptors than k),
    then the same words and BoW vectors for noisy views with invalid rows."""
    centers, train = _corpus(rng)
    ref = jx_voc.build_vocabulary(train, k=k, depth=depth, seed=seed)
    got = vocabulary.build_vocabulary(train, k=k, depth=depth, seed=seed, device="cpu")
    _assert_vocab_equal(got, ref)
    got_i32 = vocabulary.build_vocabulary(train.view(np.int32), k=k, depth=depth, seed=seed,
                                          device="cpu")
    _assert_vocab_equal(got_i32, ref)
    q = np.concatenate([_noisy(rng, c, 4) for c in centers[:10]])
    valid = rng.random(len(q)) < 0.8
    _assert_transform_equal(got, ref, q, valid)
    assert vocabulary.transform(got, _i32(q), torch.zeros(len(q), dtype=torch.bool))[1].abs(
    ).sum() == 0


def test_transform_takes_the_first_child_on_ties():
    """A built tree whose descent meets ties at both levels: child 1 and 2
    at distance 1 (child 0 far), then under node 1 its children 0 and 1 at
    distance 2: the word is the first of the least on both levels, as
    jnp.argmin, and equal to JAX's."""
    z = np.zeros(8, np.uint32)

    def bits(*b):
        d = z.copy()
        for i in b:
            d[i // 32] |= np.uint32(1) << np.uint32(i % 32)
        return d

    far = np.full(8, 0xFFFFFFFF, np.uint32)
    level0 = np.stack([far, bits(3), bits(4)])
    level1 = np.stack([far, far, far, bits(5, 6), bits(7, 8), far, far, far, far])
    voc_j = jx_voc.Vocabulary((jnp.asarray(level0), jnp.asarray(level1)),
                              jnp.asarray(np.arange(9, dtype=np.float32) + 1), 3, 2)
    voc_p = _port_of(voc_j)
    q = np.stack([z, bits(3), bits(4)])
    wp, _ = _assert_transform_equal(voc_p, voc_j, q, np.ones(3, bool))
    assert wp.tolist() == [3, 3, 6]


def test_direct_index_nodes_equals_jax(rng):
    _, train = _corpus(rng, 10, 25)
    ref = jx_voc.build_vocabulary(train, k=3, depth=3, seed=6)
    got = _port_of(ref)
    words = np.array([0, 1, 2, 3, 8, 9, 26], np.int32)
    for up in (0, 1, 2, 3, 5):
        np.testing.assert_array_equal(
            vocabulary.direct_index_nodes(got, torch.tensor(words), up).numpy(),
            np.asarray(jx_voc.direct_index_nodes(ref, jnp.asarray(words), up)))


def test_bundled_vocabulary_equals_jax(rng):
    """The tracker's default artifact (k 10, L 5, read by path from the JAX
    package's data) loads equal, and 1024 descriptors (drawn near 64
    random level-4 centroids, 10 % invalid) take the same words."""
    path = BUNDLED_VOCABULARIES[0]
    ref = jx_voc.load_vocabulary(path)
    got = vocabulary.load_vocabulary(path, device="cpu")
    _assert_vocab_equal(got, ref)
    assert got.n_words == 100_000
    leaves = np.asarray(ref.node_desc[-1])[rng.integers(0, 100_000, 64)]
    q = np.concatenate([_noisy(rng, c, 16, k=20) for c in leaves])
    _assert_transform_equal(got, ref, q, rng.random(len(q)) < 0.9)


def _db_pair(rng, scoring_vocab=(5, 3, 3)):
    centers, train = _corpus(rng)
    k, depth, seed = scoring_vocab
    voc_j = jx_voc.build_vocabulary(train, k=k, depth=depth, seed=seed)
    voc_p = _port_of(voc_j)
    scenes = [np.concatenate([_noisy(rng, centers[i], 5) for i in idx])
              for idx in (range(8), range(8), range(8, 16), range(4, 12))]
    bows_j = [jx_voc.transform(voc_j, jnp.asarray(s), jnp.ones(len(s), bool))[1] for s in scenes]
    bows_p = [vocabulary.transform(voc_p, _i32(s), torch.ones(len(s), dtype=torch.bool))[1]
              for s in scenes]
    return bows_j, bows_p


@pytest.mark.parametrize("scoring", sorted(database.SCORINGS))
def test_scorers_and_query_equal_jax(rng, scoring):
    """Each scoring, pairwise and as a query of a 6-slot database with one
    slot removed: within 2e-6 of JAX's (f32 sums over 125 words of values
    <= 1, in another order; KL's log terms reach ~36, so 2e-5 there; L2's
    1 - sqrt(1 - dot) turns the dot product's few-ulp rounding near 1 into
    sqrt(4 * 2^-23) ~ 7e-4, so 1e-3 there), invalid slots -inf, and the
    revisit ranked first as in test_bow."""
    bows_j, bows_p = _db_pair(rng)
    tol = {"kl": 2e-5, "l2": 1e-3}.get(scoring, 2e-6)
    for a in range(4):
        for b in range(4):
            np.testing.assert_allclose(
                float(database.score_pairwise(bows_p[a], bows_p[b], scoring)),
                float(jx_db.score_pairwise(bows_j[a], bows_j[b], scoring)), atol=tol)
    db_j = jx_db.empty_database(6, bows_j[0].shape[0])
    db_p = database.empty_database(6, bows_p[0].shape[0], "cpu")
    for slot, i in ((0, 0), (2, 2), (3, 3), (5, 2)):
        db_j = jx_db.add_keyframe(db_j, slot, bows_j[i])
        db_p = database.add_keyframe(db_p, slot, bows_p[i])
    db_j, db_p = jx_db.remove_keyframe(db_j, 5), database.remove_keyframe(db_p, 5)
    np.testing.assert_allclose(db_p.bow.numpy(), np.asarray(db_j.bow), atol=1e-6)
    np.testing.assert_array_equal(db_p.valid.numpy(), np.asarray(db_j.valid))
    ref = np.asarray(jx_db.query(db_j, bows_j[1], scoring=scoring))
    got = database.query(db_p, bows_p[1], scoring=scoring).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], atol=tol)
    assert int(np.argmax(got)) == 0 and np.isneginf(got[[1, 4, 5]]).all()


def test_match_descriptors_bow_exact(rng):
    """matches12 equal to JAX's: descriptors near 40 centres (with repeats
    that tie best and second best), nodes from a vocabulary's direct index
    two levels up, invalid rows and columns, ratios 0.7 and 0.75."""
    centers, train = _corpus(rng, 40, 10)
    voc_j = jx_voc.build_vocabulary(train, k=4, depth=3, seed=1)
    voc_p = _port_of(voc_j)
    d1 = np.concatenate([_noisy(rng, c, 6, k=20) for c in centers])
    d2 = np.concatenate([_noisy(rng, c, 4, k=20) for c in centers] + [d1[:30]])
    v1, v2 = rng.random(len(d1)) < 0.9, rng.random(len(d2)) < 0.9
    w1, _ = jx_voc.transform(voc_j, jnp.asarray(d1), jnp.asarray(v1))
    w2, _ = jx_voc.transform(voc_j, jnp.asarray(d2), jnp.asarray(v2))
    n1, n2 = (jx_voc.direct_index_nodes(voc_j, w) for w in (w1, w2))
    for ratio in (0.7, 0.75):
        ref = np.asarray(jx_matcher.match_descriptors_bow(
            jnp.asarray(d1), jnp.asarray(v1), n1, jnp.asarray(d2), jnp.asarray(v2), n2,
            ratio=ratio))
        got = match_descriptors_bow(_i32(d1), torch.tensor(v1), torch.tensor(np.asarray(n1)),
                                    _i32(d2), torch.tensor(v2), torch.tensor(np.asarray(n2)),
                                    ratio=ratio).numpy()
        np.testing.assert_array_equal(got, ref)
        assert (ref >= 0).sum() > 20
    pw1, _ = vocabulary.transform(voc_p, _i32(d1), torch.tensor(v1))
    np.testing.assert_array_equal(vocabulary.direct_index_nodes(voc_p, pw1).numpy(),
                                  np.asarray(n1))


@pytest.mark.parametrize("fmt", ["npz", "txt"])
def test_vocabulary_files_cross_read(rng, tmp_path, fmt):
    """The npz artifact and DBoW2's text format, each way: the port reads
    what JAX wrote and JAX reads what the port wrote, to the same tree (the
    text format keeps weights to 6 decimals, as both write it), the same
    words and BoW vectors within 1e-6."""
    _, train = _corpus(rng, 15, 25)
    voc_j = jx_voc.build_vocabulary(train, k=3, depth=3, seed=5)
    voc_p = _port_of(voc_j)
    save_j, save_p, load_j, load_p = (
        (jx_voc.save_vocabulary, vocabulary.save_vocabulary, jx_voc.load_vocabulary,
         vocabulary.load_vocabulary) if fmt == "npz" else
        (jx_voc.save_orbvoc_text, vocabulary.save_orbvoc_text, jx_voc.load_vocabulary,
         vocabulary.load_vocabulary))
    pj, pp = tmp_path / f"jax.{fmt}", tmp_path / f"port.{fmt}"
    save_j(voc_j, pj)
    save_p(voc_p, pp)
    if fmt == "txt":
        assert pj.read_text() == pp.read_text()
    else:
        a, b = np.load(pj), np.load(pp)
        assert sorted(a.files) == sorted(b.files)
        for f in a.files:
            assert a[f].dtype == b[f].dtype, f
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)
    from_j = vocabulary.load_vocabulary(pj, device="cpu")
    from_p = load_j(pp)
    _assert_vocab_equal(from_j, load_j(pj))
    _assert_vocab_equal(load_p(pp, device="cpu"), from_p)
    q = _noisy(rng, train[0], 64)
    _assert_transform_equal(from_j, from_p, q, np.ones(64, bool))


@pytest.mark.parametrize("case", ["ragged", "padded"])
def test_orbvoc_ragged_and_padded_equal_jax(rng, tmp_path, case):
    """tests/test_orbvoc.py's hand-made DBoW2 files (a ragged tree: a node
    with one child, a leaf above the bottom; a node with padded slots): the
    port's reader gives JAX's tree and JAX's words, padded slots never
    reached."""
    zeros, ones = " ".join(["0"] * 32), " ".join(["255"] * 32)
    if case == "ragged":
        half = " ".join(["255"] * 16 + ["0"] * 16)
        lines = ["2 2 0 0", f"0 0 {zeros} 0", f"0 1 {ones} 2.5", f"1 1 {half} 1.5"]
        q = np.zeros((2, 8), np.uint32)
        q[0] = np.frombuffer(bytes([255] * 32), np.uint32)
        q[1] = np.frombuffer(bytes([255] * 16 + [0] * 16), np.uint32)
        want = {2, 0}
    else:
        lines = ["3 1 0 0", f"0 1 {zeros} 1.0", f"0 1 {ones} 2.0"]
        q = rng.integers(0, 2**32, (256, 8), dtype=np.uint32)
        want = {0, 1}
    p = tmp_path / f"{case}.txt"
    p.write_text("\n".join(lines) + "\n")
    ref = jx_voc.load_orbvoc_text(p)
    got = vocabulary.load_orbvoc_text(p, device="cpu")
    _assert_vocab_equal(got, ref)
    w, _ = _assert_transform_equal(got, ref, q, np.ones(len(q), bool))
    assert set(w.tolist()) <= want
