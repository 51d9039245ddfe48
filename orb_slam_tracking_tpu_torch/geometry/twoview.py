"""Two-view monocular initialization (counterpart of
``geometry/twoview.py``, ``Initializer::Initialize``): batched H and F
RANSAC, model selection by RH = SH / (SH + SF), pose candidates, and
their vetting by triangulation (``CheckRT``), as one fixed-shape program.

The hypotheses' uniforms come in as arguments (``u_h``, ``u_f``
[iters, 8] in [0, 1)); the JAX package draws them from the two halves of
a split PRNG key. Selected rows are taken with ``index_select`` so that
no index is read back to the host; ``torch.linalg.eigh`` and ``svd``
still check their convergence on the host (there is no ``_ex`` form of
either), and ``inv`` uses ``inv_ex``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import InitConfig
from .fundamental import decompose_essential, solve_f_8point
from .homography import decompose_homography, solve_h_dlt
from .sampling import sample_distinct
from .triangulate import triangulate_dlt

__all__ = ["TwoViewResult", "initialize_two_view", "score_homography",
           "score_fundamental"]

_COS_PARALLAX_MAX = 0.99998  # Initializer.cpp:664-670


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # [] bool
    R21: torch.Tensor              # [3, 3] frame-1 -> frame-2 rotation
    t21: torch.Tensor              # [3] unit-norm translation
    points3d: torch.Tensor         # [M, 3] in frame-1 camera coords
    tri_mask: torch.Tensor         # [M] bool triangulated and vetted
    used_homography: torch.Tensor  # [] bool
    score_h: torch.Tensor          # [] float32
    score_f: torch.Tensor          # [] float32
    n_inliers: torch.Tensor        # [] int32 inliers of the selected model
    n_good: torch.Tensor           # [] int32 vetted triangulations
    parallax_deg: torch.Tensor     # [] float32


def _to_h(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _take(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``x[i]`` for a 0-d index tensor, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _transfer(H: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """H [..., 3, 3] applied to homogeneous points p [M, 3] -> [..., M, 2]."""
    q = p @ H.transpose(-1, -2)
    z = q[..., 2:]
    return q[..., :2] / torch.where(z.abs() < 1e-12, 1e-12, z)


def score_homography(H21, x1, x2, valid, sigma):
    """Symmetric-transfer chi2 score (``CheckHomography``). H21 may be
    batched [..., 3, 3]; x1/x2 are [M, 2]. -> (score [...], inliers
    [..., M])."""
    th = 5.991
    inv_sigma2 = 1.0 / (sigma * sigma)
    H12 = torch.linalg.inv_ex(H21).inverse
    chi2_2 = ((x2 - _transfer(H21, _to_h(x1))) ** 2).sum(dim=-1) * inv_sigma2
    chi2_1 = ((x1 - _transfer(H12, _to_h(x2))) ** 2).sum(dim=-1) * inv_sigma2
    in1 = chi2_1 < th
    in2 = chi2_2 < th
    score = (torch.where(valid & in1, th - chi2_1, 0.0)
             + torch.where(valid & in2, th - chi2_2, 0.0)).sum(dim=-1)
    return score, in1 & in2 & valid


def score_fundamental(F21, x1, x2, valid, sigma):
    """Epipolar chi2 score (``CheckFundamental``): point-to-line distances
    both ways, th 3.841, score threshold 5.991."""
    th = 3.841
    th_score = 5.991
    inv_sigma2 = 1.0 / (sigma * sigma)
    p1 = _to_h(x1)
    p2 = _to_h(x2)
    l2 = p1 @ F21.transpose(-1, -2)           # F21 p1, [..., M, 3]
    num2 = (p2 * l2).sum(dim=-1)
    den2 = l2[..., 0] ** 2 + l2[..., 1] ** 2
    chi2_2 = (num2 * num2) / den2.clamp_min(1e-12) * inv_sigma2
    l1 = p2 @ F21                             # F21ᵀ p2
    num1 = (p1 * l1).sum(dim=-1)
    den1 = l1[..., 0] ** 2 + l1[..., 1] ** 2
    chi2_1 = (num1 * num1) / den1.clamp_min(1e-12) * inv_sigma2
    in1 = chi2_1 < th
    in2 = chi2_2 < th
    score = (torch.where(valid & in1, th_score - chi2_1, 0.0)
             + torch.where(valid & in2, th_score - chi2_2, 0.0)).sum(dim=-1)
    return score, in1 & in2 & valid


def _check_rt(R, t, x1, x2, valid, K, sigma2):
    """Vet candidate poses R [C, 3, 3], t [C, 3] by triangulation
    (``CheckRT``, Initializer.cpp:569-713). -> (n_good [C], parallax_deg
    [C], pts [C, M, 3], good [C, M])."""
    C, M = R.shape[0], x1.shape[0]
    eye34 = torch.cat([torch.eye(3, dtype=K.dtype, device=K.device),
                       K.new_zeros(3, 1)], dim=1)
    P1 = (K @ eye34)[None].expand(C, 3, 4)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)         # [C, 3, 4]
    x1b = x1[None].expand(C, M, 2)
    x2b = x2[None].expand(C, M, 2)
    pts = triangulate_dlt(P1, P2, x1b, x2b)              # [C, M, 3]

    finite = torch.isfinite(pts).all(dim=-1)
    O2 = -(R.transpose(-1, -2) @ t[..., None])[..., 0]   # camera-2 centre
    n1 = pts
    n2 = pts - O2[:, None, :]
    cos_par = (n1 * n2).sum(dim=-1) / (
        torch.linalg.vector_norm(n1, dim=-1)
        * torch.linalg.vector_norm(n2, dim=-1)).clamp_min(1e-12)
    z1 = pts[..., 2]
    p2c = pts @ R.transpose(-1, -2) + t[:, None, :]
    z2 = p2c[..., 2]
    low_par = cos_par < _COS_PARALLAX_MAX
    # negative depth rejects a point only where the parallax is finite
    pass_depth = ~(((z1 <= 0) | (z2 <= 0)) & low_par)

    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(p, x):
        zi = torch.where(p[..., 2].abs() < 1e-12, 1e-12, p[..., 2])
        u = fx * p[..., 0] / zi + cx
        v = fy * p[..., 1] / zi + cy
        return (u - x[..., 0]) ** 2 + (v - x[..., 1]) ** 2

    th = 4.0 * sigma2
    pass_reproj = (reproj_err(pts, x1b) < th) & (reproj_err(p2c, x2b) < th)

    # nGood counts every vetted triangulation; the parallax flag gates only
    # the per-point mask (the reference's CheckRT)
    counted = valid[None, :] & finite & pass_depth & pass_reproj
    good = counted & low_par
    n_good = counted.sum(dim=-1, dtype=torch.int32)

    # parallax statistic: the 50th-smallest cos among counted points
    cos_sorted = torch.sort(torch.where(counted, cos_par, 1.0), dim=-1).values
    idx = (n_good - 1).clamp(0, 50).to(torch.int64)
    sel = torch.gather(cos_sorted, -1, idx[:, None])[:, 0]
    parallax = torch.rad2deg(torch.arccos(sel.clamp(-1.0, 1.0)))
    parallax = torch.where(n_good > 0, parallax, 0.0)
    return n_good, parallax, pts, good


def _best_model(solver, scorer, u, n_valid, x1, x2, valid, sigma):
    """RANSAC over the hypotheses drawn from ``u``, then one refit on the
    winner's inliers, kept if it scores higher."""
    idx = sample_distinct(u, n_valid, 8).to(torch.int64)  # [S, 8]
    models = solver(x1[idx], x2[idx])                     # [S, 3, 3]
    scores, inliers = scorer(models, x1, x2, valid, sigma)
    b = torch.argmax(scores)                              # first on ties
    score_b = _take(scores, b)
    w = _take(inliers, b).to(x1.dtype)
    refit = solver(x1[None], x2[None], w[None])[0]
    r_score, r_inliers = scorer(refit, x1, x2, valid, sigma)
    better = r_score > score_b
    return (torch.where(better, refit, _take(models, b)),
            torch.where(better, r_score, score_b),
            torch.where(better, r_inliers, _take(inliers, b)))


def initialize_two_view(x1: torch.Tensor, x2: torch.Tensor,
                        valid: torch.Tensor, K: torch.Tensor,
                        u_h: torch.Tensor, u_f: torch.Tensor,
                        cfg: InitConfig) -> TwoViewResult:
    """Two-view bootstrap on matched, undistorted level-0 pixels.

    x1, x2 [M, 2] compacted match coordinates (front-packed, see
    ``ops.matcher.compact_matches``), valid [M], K [3, 3]; ``u_h``/``u_f``
    [cfg.ransac_iterations, 8] uniforms for the H and F hypotheses."""
    sigma = cfg.sigma
    n_valid = valid.sum(dtype=torch.int32)

    H, sh, in_h = _best_model(solve_h_dlt, score_homography, u_h, n_valid,
                              x1, x2, valid, sigma)
    F, sf, in_f = _best_model(solve_f_8point, score_fundamental, u_f, n_valid,
                              x1, x2, valid, sigma)

    rh = sh / (sh + sf).clamp_min(1e-12)
    use_h = rh > cfg.rh_threshold  # Initializer.cpp:111

    # pose candidates of both models, selected by masking
    Rh, th_, vh = decompose_homography(H, K)              # [8, ...]
    Rf, tf_ = decompose_essential(F, K)                   # [4, ...]
    Rf = torch.cat([Rf, torch.eye(3, dtype=K.dtype, device=K.device).expand(4, 3, 3)])
    tf_ = torch.cat([tf_, tf_.new_zeros(4, 3)])
    vf = torch.arange(8, device=K.device) < 4

    Rc = torch.where(use_h, Rh, Rf)
    tc = torch.where(use_h, th_, tf_)
    vc = torch.where(use_h, vh, vf)
    inlier = torch.where(use_h, in_h, in_f)
    n_inliers = inlier.sum(dtype=torch.int32)

    n_good, parallax, pts, good = _check_rt(Rc, tc, x1, x2, inlier, K,
                                            sigma * sigma)
    n_good = torch.where(vc, n_good, -1)

    # near-identical candidates (coinciding Faugeras sign combinations) must
    # not pose as competing interpretations in the ambiguity gate: keep the
    # first of each group
    rel_trace = torch.einsum("cij,dij->cd", Rc, Rc)      # tr(Rcᵀ Rd)
    t_dot = tc @ tc.T
    same = (rel_trace > 3.0 - 1e-4) & (t_dot > 1.0 - 1e-4)
    ic = torch.arange(Rc.shape[0], device=K.device)
    dup = (same & (ic[None, :] < ic[:, None])).any(dim=1)
    n_good = torch.where(dup, -1, n_good)

    order = torch.argsort(-n_good, stable=True)
    best = order[0]
    best_good = _take(n_good, best)
    second_good = _take(n_good, order[1])

    # acceptance gates (Initializer.cpp:517-554)
    min_good = torch.clamp((0.9 * n_inliers.float()).to(torch.int32),
                           min=cfg.min_triangulated)
    unambiguous = second_good.float() < 0.7 * best_good.float()
    parallax_best = _take(parallax, best)
    success = ((n_valid >= cfg.min_matches) & (best_good >= min_good)
               & unambiguous & (parallax_best > cfg.min_parallax_deg))

    return TwoViewResult(
        success=success,
        R21=_take(Rc, best),
        t21=_take(tc, best),
        points3d=_take(pts, best),
        tri_mask=_take(good, best) & success,
        used_homography=use_h,
        score_h=sh,
        score_f=sf,
        n_inliers=n_inliers,
        n_good=best_good,
        parallax_deg=parallax_best,
    )
