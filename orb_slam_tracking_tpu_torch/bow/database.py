"""Keyframe recognition database (counterpart of ``bow/database.py``):
dense BoW scoring against every stored keyframe.

The database is a ``[max_keyframes, n_words]`` f32 matrix of L1-normalized
BoW vectors with a validity mask, on the tracker's device; a query scores
the vector against every row at once. The six scorings of DBoW2's
``ScoringObject`` (L1 the default, L2, chi-square, KL, Bhattacharyya, dot
product) are written as the JAX package's, matrix products in full f32
(TF32 off, ``device.full_f32``). ``add_keyframe`` and ``remove_keyframe``
return a new database and leave the one they are given as it was.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

__all__ = ["KeyframeDatabase", "empty_database", "add_keyframe", "remove_keyframe",
           "query", "SCORINGS", "score_pairwise"]

# log(DBL_EPSILON), the KL score of a word the database vector lacks
_LOG_EPS = float(np.log(np.finfo(np.float64).eps))


def _score_l1(q, db):
    # 1 - 0.5 |v - w|_1
    return 1.0 - 0.5 * (db - q[None, :]).abs().sum(dim=-1)


def _score_l2(q, db):
    # 1 - sqrt(1 - <v, w>) on L2-normalized vectors, clamped at rounding
    qn = q / torch.clamp_min(torch.linalg.vector_norm(q), 1e-12)
    dn = db / torch.clamp_min(torch.linalg.vector_norm(db, dim=-1, keepdim=True), 1e-12)
    dot = dn @ qn
    return torch.where(dot >= 1.0, 1.0, 1.0 - torch.sqrt(torch.clamp_min(1.0 - dot, 0.0)))


def _score_chi2(q, db):
    # 2 sum v w / (v + w)
    s = db + q[None, :]
    return 2.0 * torch.where(s != 0.0, db * q[None, :] / torch.where(s == 0.0, 1.0, s),
                             0.0).sum(dim=-1)


def _score_kl(q, db):
    # -KL(q || w) over q's support, absent database words at log(eps)
    v = q[None, :]
    logw = torch.where(db > 0, torch.log(torch.where(db > 0, db, 1.0)), _LOG_EPS)
    kl = torch.where(v > 0, v * (torch.log(torch.where(v > 0, v, 1.0)) - logw), 0.0)
    return -kl.sum(dim=-1)


def _score_bhattacharyya(q, db):
    # sum sqrt(v w)
    return torch.sqrt(db * q[None, :]).sum(dim=-1)


def _score_dot(q, db):
    # sum v w
    return db @ q


SCORINGS = {"l1": _score_l1, "l2": _score_l2, "chi2": _score_chi2, "kl": _score_kl,
            "bhattacharyya": _score_bhattacharyya, "dot": _score_dot}


def score_pairwise(v: torch.Tensor, w: torch.Tensor, scoring: str = "l1") -> torch.Tensor:
    """The score of two BoW vectors (DBoW2 ``Vocabulary::score``)."""
    return SCORINGS[scoring](v, w[None, :])[0]


class KeyframeDatabase(NamedTuple):
    bow: torch.Tensor    # [Kmax, n_words] float32, L1-normalized rows
    valid: torch.Tensor  # [Kmax] bool


def empty_database(max_keyframes: int, n_words: int,
                   device: torch.device | str) -> KeyframeDatabase:
    return KeyframeDatabase(
        bow=torch.zeros((max_keyframes, n_words), dtype=torch.float32, device=device),
        valid=torch.zeros(max_keyframes, dtype=torch.bool, device=device))


def _row(db: KeyframeDatabase, slot) -> torch.Tensor:
    return torch.arange(db.valid.shape[0], device=db.valid.device) == slot


def add_keyframe(db: KeyframeDatabase, slot, bow_vec: torch.Tensor) -> KeyframeDatabase:
    """Row ``slot`` (an int) set to ``bow_vec`` and marked valid."""
    row = _row(db, slot)
    return KeyframeDatabase(bow=torch.where(row[:, None], bow_vec[None, :], db.bow),
                            valid=db.valid | row)


def remove_keyframe(db: KeyframeDatabase, slot) -> KeyframeDatabase:
    """Row ``slot`` dropped from the index (TemplatedDatabase's erase)."""
    return KeyframeDatabase(bow=db.bow, valid=db.valid & ~_row(db, slot))


def query(db: KeyframeDatabase, bow_vec: torch.Tensor, scoring: str = "l1") -> torch.Tensor:
    """Scores [Kmax] of the query against every stored keyframe, -inf at
    invalid rows; the candidate policy is the caller's."""
    return torch.where(db.valid, SCORINGS[scoring](bow_vec, db.bow), -torch.inf)
