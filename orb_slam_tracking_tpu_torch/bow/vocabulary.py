"""Bag-of-binary-words vocabulary (counterpart of ``bow/vocabulary.py``):
a dense complete tree of branching factor k and depth L over packed
descriptors, its batched descent and tf-idf weights.

- ``node_desc[l]`` [k^(l+1), 8] int32 (the JAX package's uint32 bits) holds
  level l's centroids, the k children of a level l-1 node contiguous;
  ``word_weight`` [k^L] f32 the leaves' idf weights.
- ``transform`` descends every descriptor in lockstep: per level, the XOR +
  popcount distance to the current node's k children and the first least
  (a distance-then-child key, so ties go to the lower child on every
  device, as ``jnp.argmin``); then the L1-normalized tf-idf vector, whose
  per-word sums are ``optim.segment``'s sorted segment sums (the same
  bits on every run, where ``index_add_`` would add in atomics' order).
- ``build_vocabulary`` (hierarchical binary k-medians with k-means++-style
  seeding, centroids the bitwise majority) and the DBoW2 text format are
  numpy on the host, copied from the JAX package so that one seed gives the
  same tree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.hamming import popcount
from ..optim.segment import segment_sum, segments

__all__ = ["Vocabulary", "vocabulary_from_numpy", "build_vocabulary", "transform",
           "save_vocabulary", "load_vocabulary", "direct_index_nodes", "load_orbvoc_text",
           "save_orbvoc_text"]


class Vocabulary(NamedTuple):
    """Dense complete-tree vocabulary with branching factor k, depth L."""

    node_desc: tuple           # length L of [k^(l+1), 8] int32 tensors
    word_weight: torch.Tensor  # [k^L] float32
    k: int
    depth: int

    @property
    def n_words(self) -> int:
        return self.k ** self.depth


def vocabulary_from_numpy(levels, word_weight, k: int, depth: int, device) -> Vocabulary:
    """The JAX package's numpy levels (uint32 words) and weights -> a
    Vocabulary on ``device``."""
    return Vocabulary(
        node_desc=tuple(torch.tensor(np.ascontiguousarray(d, np.uint32).view(np.int32),
                                     device=device) for d in levels),
        word_weight=torch.tensor(np.asarray(word_weight, np.float32), device=device),
        k=k, depth=depth)


def _levels_u32(voc: Vocabulary):
    return [d.cpu().numpy().view(np.uint32) for d in voc.node_desc]


# --- training (host numpy, as the JAX package's) ---------------------------

def _bitwise_majority(descs: np.ndarray) -> np.ndarray:
    """Majority vote per bit over [N, 8] uint32 (FORB::meanValue)."""
    if len(descs) == 0:
        return np.zeros(8, np.uint32)
    bits = np.unpackbits(descs.view(np.uint8), axis=1, bitorder="little")
    maj = (bits.sum(0) * 2 >= len(descs)).astype(np.uint8)
    return np.packbits(maj, bitorder="little").view(np.uint32)


# set bits of every uint16: a descriptor distance is 16 lookups
_POP16 = np.unpackbits(np.arange(1 << 16, dtype=np.uint16).view(np.uint8)
                       ).reshape(-1, 16).sum(1).astype(np.uint8)


def _hamming_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[N, 8] x [M, 8] uint32 -> [N, M] int32 distances."""
    a16 = np.ascontiguousarray(a).view(np.uint16)
    b16 = np.ascontiguousarray(b).view(np.uint16)
    return _POP16[np.bitwise_xor(a16[:, None, :], b16[None, :, :])].sum(-1, dtype=np.int32)


def _kmedians(rng, descs: np.ndarray, k: int, iters: int = 8) -> np.ndarray:
    """Binary k-medians with k-means++-style seeding on Hamming distance;
    -> [k, 8] centroids."""
    n = len(descs)
    if n == 0:
        return np.zeros((k, 8), np.uint32)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = descs
        out[n:] = descs[rng.integers(0, n, k - n)]
        return out
    centers = [descs[rng.integers(n)]]
    d2 = _hamming_np(descs, centers[0][None]).ravel().astype(np.float64)
    for _ in range(k - 1):
        p = d2 / max(d2.sum(), 1e-9)
        centers.append(descs[rng.choice(n, p=p)])
        np.minimum(d2, _hamming_np(descs, centers[-1][None]).ravel(), out=d2)
    C = np.stack(centers)
    for _ in range(iters):
        assign = _hamming_np(descs, C).argmin(1)
        newC = C.copy()
        for j in range(k):
            sel = descs[assign == j]
            if len(sel):
                newC[j] = _bitwise_majority(sel)
        if (newC == C).all():
            break
        C = newC
    return C


def build_vocabulary(descs: np.ndarray, k: int = 10, depth: int = 4, seed: int = 0,
                     device: torch.device | str = DEFAULT_DEVICE) -> Vocabulary:
    """Train a (k, L) vocabulary from [N, 8] training descriptors (numpy
    uint32 or int32 words) on the host; the tree is put on ``device``.
    Each training descriptor counts as one document of the idf weights
    (TemplatedVocabulary's TF_IDF)."""
    device = resolve_device(device)
    descs = np.ascontiguousarray(descs)
    descs = descs.view(np.uint32) if descs.dtype == np.int32 else descs.astype(np.uint32)
    rng = np.random.default_rng(seed)
    levels = []
    assign = np.zeros(len(descs), np.int64)
    n_nodes = 1
    for _ in range(depth):
        centers = np.zeros((n_nodes * k, 8), np.uint32)
        new_assign = np.zeros_like(assign)
        order = np.argsort(assign, kind="stable")
        bounds = np.searchsorted(assign[order], np.arange(n_nodes + 1))
        for node in range(n_nodes):
            sel = order[bounds[node]:bounds[node + 1]]
            C = _kmedians(rng, descs[sel], k)
            centers[node * k:(node + 1) * k] = C
            if len(sel):
                new_assign[sel] = node * k + _hamming_np(descs[sel], C).argmin(1)
        levels.append(centers)
        assign = new_assign
        n_nodes *= k
    counts = np.bincount(assign, minlength=n_nodes).astype(np.float64)
    w = np.log(max(len(descs), 1) / np.maximum(counts, 1.0))
    w[counts == 0] = 0.0
    return vocabulary_from_numpy(levels, w.astype(np.float32), k, depth, device)


# --- descent ----------------------------------------------------------------

def _descend(voc: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """Each descriptor's leaf: per level, the first child of least Hamming
    distance. -> word [N] int64."""
    k = voc.k
    child = torch.arange(k, dtype=torch.int64, device=desc.device)
    node = torch.zeros(desc.shape[0], dtype=torch.int64, device=desc.device)
    for children in voc.node_desc:
        idx = node[:, None] * k + child                        # [N, k]
        d = popcount(desc[:, None, :] ^ children[idx]).sum(-1, dtype=torch.int64)
        node = node * k + (d * k + child).amin(dim=1) % k
    return node


def transform(voc: Vocabulary, desc: torch.Tensor, valid: torch.Tensor):
    """Descend ``desc [N, 8]`` int32 through the tree. -> (word [N] int32,
    bow [n_words] f32: the L1-normalized sum of the valid features' word
    weights, DBoW2's ``BowVector``)."""
    word = _descend(voc, desc)
    # invalid features are in no segment (the JAX package adds their 0s)
    bow = segment_sum(voc.word_weight[word], segments(word, voc.n_words, valid))
    norm = bow.abs().sum()
    return word.to(torch.int32), bow / torch.where(norm > 0, norm, 1.0)


def direct_index_nodes(voc: Vocabulary, word: torch.Tensor, levels_up: int = 2) -> torch.Tensor:
    """Each word's ancestor ``levels_up`` levels above the leaves (DBoW2's
    ``FeatureVector`` node): the tree is complete, so an integer divide."""
    lu = min(max(levels_up, 0), voc.depth)
    return word // (voc.k ** lu)


# --- files ------------------------------------------------------------------

def save_vocabulary(voc: Vocabulary, path) -> None:
    """The JAX package's npz artifact (uint32 levels, f32 weights)."""
    np.savez_compressed(
        path, word_weight=voc.word_weight.cpu().numpy(), k=np.int64(voc.k),
        depth=np.int64(voc.depth),
        **{f"level_{i}": d for i, d in enumerate(_levels_u32(voc))})


def load_orbvoc_text(path, device: torch.device | str = DEFAULT_DEVICE) -> Vocabulary:
    """Read a DBoW2 text vocabulary (``k L scoring weighting``, then per node
    ``parent is_leaf b0 .. b31 weight``) into the dense tree: a node with
    fewer than k children pads its slots with copies of its first child
    (the first-index descent never reaches them; their leaves weigh 0), and
    a leaf above the bottom is chained down with its own descriptor."""
    device = resolve_device(device)
    with open(path) as f:
        header = f.readline().split()
        if len(header) < 2:
            raise ValueError(f"{path}: bad ORBvoc header {header!r}")
        k, depth = int(header[0]), int(header[1])
        body = np.loadtxt(f, dtype=np.float64, ndmin=2)
    if body.shape[1] != 35:
        raise ValueError(f"{path}: expected 35 columns (parent is_leaf 32-byte-desc "
                         f"weight), got {body.shape[1]}")
    n = body.shape[0]
    parent = body[:, 0].astype(np.int64)
    weight = body[:, 34].astype(np.float32)
    descs = np.ascontiguousarray(body[:, 2:34].astype(np.uint8)).view(np.uint32)
    kids: list = [[] for _ in range(n + 1)]
    for row in np.argsort(parent, kind="stable"):
        kids[parent[row]].append(int(row) + 1)
    levels = [np.zeros((k ** (lvl + 1), 8), np.uint32) for lvl in range(depth)]
    word_weight = np.zeros(k ** depth, np.float32)
    stack = [(0, 0, 0)]  # (node id, level of its children, its dense index)
    while stack:
        nid, lvl, didx = stack.pop()
        ch = kids[nid]
        if not ch:
            d, w = descs[nid - 1], weight[nid - 1]
            for l2 in range(lvl, depth):
                didx = didx * k
                levels[l2][didx] = d
            word_weight[didx] = w
            continue
        first_desc = descs[ch[0] - 1]
        for j in range(k):
            cid = ch[j] if j < len(ch) else None
            slot = didx * k + j
            levels[lvl][slot] = descs[cid - 1] if cid is not None else first_desc
            if cid is None:
                continue
            if lvl + 1 == depth:
                word_weight[slot] = weight[cid - 1]
            else:
                stack.append((cid, lvl + 1, slot))
    return vocabulary_from_numpy(levels, word_weight, k, depth, device)


def save_orbvoc_text(voc: Vocabulary, path) -> None:
    """Write DBoW2's text format (L1_NORM / TF_IDF header fields, internal
    nodes weighing 0), breadth first."""
    k, depth = voc.k, voc.depth
    lines = [f"{k} {depth} 0 0"]
    ww = voc.word_weight.cpu().numpy()
    for lvl, d in enumerate(_levels_u32(voc)):
        descs = d.view(np.uint8)
        is_leaf = 1 if lvl + 1 == depth else 0
        base_parent = ((k ** lvl - 1) // (k - 1)) if k > 1 else lvl
        for idx in range(descs.shape[0]):
            pid = 0 if lvl == 0 else base_parent + idx // k
            w = float(ww[idx]) if is_leaf else 0.0
            lines.append(f"{pid} {is_leaf} {' '.join(str(int(b)) for b in descs[idx])} {w:.6f}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def load_vocabulary(path, device: torch.device | str = DEFAULT_DEVICE) -> Vocabulary:
    """A DBoW2 text vocabulary (``.txt``) or the npz artifact."""
    if str(path).endswith(".txt"):
        return load_orbvoc_text(path, device)
    device = resolve_device(device)
    with np.load(path) as z:
        k, depth = int(z["k"]), int(z["depth"])
        levels = [z[f"level_{i}"].astype(np.uint32) for i in range(depth)]
        for lvl, d in enumerate(levels):
            if d.shape != (k ** (lvl + 1), 8):
                raise ValueError(f"vocabulary level {lvl} has shape {d.shape}, "
                                 f"expected {(k ** (lvl + 1), 8)}")
        return vocabulary_from_numpy(levels, z["word_weight"], k, depth, device)
