"""Loop closing (counterpart of ``slam/loop_closing.py``): place
recognition -> Sim(3) -> map correction -> essential-graph optimization,
ORB-SLAM's LoopClosing thread run after a keyframe insert.

1. ``detect``: a BoW query of the keyframe database, the current
   keyframe's covisibility group and recent keyframes excluded, gated by
   the worst covisible neighbour's score, then the consistency filter (a
   candidate's covisibility group must recur over ``loop_consistency_th``
   consecutive inserts).
2. ``compute_sim3``: descriptor matches between the two keyframes'
   point-associated keypoints (``match_descriptors_bow`` under a
   vocabulary, else ``match_descriptors``), ``ransac_sim3`` on the 3D-3D
   pairs in the two camera frames, then two rounds of match growing by
   bidirectional Sim(3) projection (``_grow_sim3_matches``, the
   ``SearchBySim3`` role) each followed by ``optimize_sim3``.
3. ``correct``: the current group's poses corrected through the measured
   Sim(3), the loop side's points fused into the current group
   (``fuse_loop_points``, ``SearchAndFuse``), the essential graph (the
   temporal chain, strong covisibility, the fuse's new covisibility and the
   loop edge) solved by ``optimize_pose_graph`` with the loop keyframe
   fixed, every point moved by its reference keyframe's correction, the
   poses written back as SE(3) ``[R, t/s]``; then, when
   ``loop_global_ba_iterations`` > 0, ``global_ba`` over the whole map.

The host/device split is the JAX package's: graph bookkeeping (the
covisibility matrix, consistency groups, edge lists, the fuse's per-point
merges, the reference keyframes) is numpy on the host, reading the map
once per use; matching, RANSAC, the Sim(3) and pose-graph LMs, the
corrections and BA run on the map's device. The B3 kernel
(``hamming_matrix``) computes the all-pairs distances of
``match_descriptors_bow``, ``_grow_sim3_matches`` and ``fuse_loop_points``;
``match_descriptors`` goes through ``hamming_gated_min``.
"""

from __future__ import annotations

from typing import List, Optional, Set, Tuple

import numpy as np
import torch

from ..bow.database import KeyframeDatabase, query
from ..bow.vocabulary import direct_index_nodes, transform
from ..config import SystemConfig
from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..geometry.sim3 import Sim3, optimize_sim3, ransac_sim3, sim3_compose, sim3_inverse
from ..ops.hamming import BIG, hamming_matrix
from ..ops.matcher import _mutual, match_descriptors, match_descriptors_bow
from ..optim.ba import bundle_adjust
from ..optim.pose_graph import optimize_pose_graph, relative_sim3
from .map import SlamMap, apply_ba_result

__all__ = ["LoopCloser", "covisibility_matrix", "covisible_slots"]

# fixed capacity of the Sim(3) correspondence arrays
_SIM3_CAP = 512
# RANSAC hypotheses of a Sim(3) solve (``ransac_sim3``'s default in JAX)
SIM3_RANSAC_ITERATIONS = 256


def _grow_sim3_matches(g: Sim3, x1, v1, d1, uv1, o1, x2, v2, d2, uv2, o2, K,
                       r_px: float, th: int, scale_factor: float) -> torch.Tensor:
    """Bidirectional Sim(3)-projection matching (``SearchBySim3``): ``x1``,
    ``x2`` [N, 3] the two keyframes' points in their own camera frames, ``g``
    frame-2 camera -> frame-1 camera. A pair (i, j) is eligible when j's
    point projects into image 1 within ``r_px * scale_factor^octave_i`` of
    keypoint i, i's point into image 2 within ``r_px *
    scale_factor^octave_j`` of keypoint j, and their Hamming distance is
    at most ``th``. -> j_for_i [N1] int32 (-1 = none), the least distance
    per row, mutual (per column the closest claimant, the lower row on
    ties)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def proj(p):
        z = torch.clamp_min(p[:, 2], 1e-9)
        return torch.stack([fx * p[:, 0] / z + cx, fy * p[:, 1] / z + cy], -1), p[:, 2] > 1e-6

    y2 = g.s * (x2 @ g.R.T) + g.t          # frame-2 points in frame 1
    gi = sim3_inverse(g)
    y1 = gi.s * (x1 @ gi.R.T) + gi.t       # frame-1 points in frame 2
    uv2_in_1, ok2 = proj(y2)
    uv1_in_2, ok1 = proj(y1)
    d_fwd = ((uv1[:, None, :] - uv2_in_1[None, :, :]) ** 2).sum(-1)
    d_bwd = ((uv1_in_2[:, None, :] - uv2[None, :, :]) ** 2).sum(-1)
    r1 = r_px * scale_factor ** o1.to(torch.float32)
    r2 = r_px * scale_factor ** o2.to(torch.float32)
    D = hamming_matrix(d1, d2)
    elig = (v1[:, None] & v2[None, :] & ok1[:, None] & ok2[None, :]
            & (d_fwd <= (r1 * r1)[:, None]) & (d_bwd <= (r2 * r2)[None, :]) & (D <= th))
    best, best_j = torch.where(elig, D, BIG).min(dim=1)
    best_j = best_j.to(torch.int32)
    keep = _mutual(best < BIG, best, best_j, x2.shape[0])
    return torch.where(keep, best_j, -1)


def covisibility_matrix(m: SlamMap) -> np.ndarray:
    """[Kc, Kc] shared map-point counts between the keyframe snapshots (the
    covisibility graph's weights), one bool product on the host."""
    kf_kp_pt = m.kf_kp_pt.cpu().numpy()
    kf_valid = m.kf_valid.cpu().numpy()
    pt_valid = m.pt_valid.cpu().numpy()
    Kc = kf_kp_pt.shape[0]
    obs = np.zeros((Kc, m.point_capacity), bool)
    rows = np.repeat(np.arange(Kc), kf_kp_pt.shape[1])
    cols = kf_kp_pt.reshape(-1)
    ok = cols >= 0
    obs[rows[ok], cols[ok]] = True
    obs &= pt_valid[None, :]
    obs[~kf_valid] = False
    shared = obs.astype(np.int32) @ obs.astype(np.int32).T
    np.fill_diagonal(shared, 0)
    return shared


def covisible_slots(m: SlamMap, slot: int, min_shared: int) -> np.ndarray:
    return np.where(covisibility_matrix(m)[slot] >= min_shared)[0]


class LoopCloser:
    """Per-map loop-closing state; call ``on_keyframe`` after every keyframe
    insert. ``vocab``: the vocabulary of the direct-index seed matching
    (None: global ratio-test matching). Runs on ``device``, where the map
    lies."""

    def __init__(self, cfg: SystemConfig, K, vocab=None,
                 device: torch.device | str = DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        full_f32(self.device)
        self.K = torch.as_tensor(K, dtype=torch.float32, device=self.device)
        self.K_np = self.K.cpu().numpy()
        self.scale_factor = float(cfg.orb.scale_factor)
        self.vocab = vocab
        self._groups: List[Tuple[Set[int], int]] = []  # (covisibility group, streak)
        self._key_counter = 0
        self.last_closed_frame_id = -(10 ** 9)
        self.last_sim3_reason = ""
        self.last_implicit_revisit: List[int] = []

    def _uniforms(self, shape):
        """The uniforms of the ``_key_counter``-th Sim(3) RANSAC, from a
        generator seeded with the counter (the JAX package draws from
        ``PRNGKey(counter)``; a test hands those draws in here)."""
        g = torch.Generator(device=self.device).manual_seed(self._key_counter)
        return torch.rand(shape, generator=g, device=self.device)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    # ------------------------------------------------------------------
    def detect(self, m: SlamMap, kf_db: KeyframeDatabase, slot: int) -> List[int]:
        """Consistent loop candidates, best BoW score first (every candidate
        whose consistency streak clears the threshold, as DetectLoop's
        mvpEnoughConsistentCandidates). A covisible neighbour old enough to
        be a candidate is recorded in ``last_implicit_revisit``: the map is
        being reused by projection, which is no loop event."""
        tcfg = self.cfg.tracker
        kf_valid = m.kf_valid.cpu().numpy()
        frame_ids = m.kf_frame_id.cpu().numpy()
        cur_fid = int(frame_ids[slot])
        shared = covisibility_matrix(m)
        neighbors = np.where(shared[slot] >= tcfg.covis_min_shared)[0]
        scores = query(kf_db, kf_db.bow[slot]).cpu().numpy()
        min_score = float(scores[neighbors].min()) if len(neighbors) else 0.0
        mask = kf_valid.copy()
        mask[slot] = False
        mask[neighbors] = False
        mask &= (cur_fid - frame_ids) >= tcfg.loop_min_frame_gap
        self.last_implicit_revisit = [
            int(c) for c in neighbors
            if kf_valid[c] and cur_fid - int(frame_ids[c]) >= tcfg.loop_min_frame_gap]
        cand_slots = np.where(mask & np.isfinite(scores) & (scores >= min_score))[0]
        new_groups: List[Tuple[Set[int], int]] = []
        accepted: List[Tuple[float, int]] = []
        for c in cand_slots:
            group = set(np.where(shared[c] >= tcfg.covis_min_shared)[0])
            group.add(int(c))
            streak = 1 + max((ps for pg, ps in self._groups if group & pg), default=0)
            new_groups.append((group, streak))
            if streak >= tcfg.loop_consistency_th:
                accepted.append((float(scores[c]), int(c)))
        self._groups = new_groups
        return [c for _, c in sorted(accepted, reverse=True)]

    # ------------------------------------------------------------------
    def compute_sim3(self, m: SlamMap, cur: int, cand: int) -> Optional[Tuple[Sim3, int]]:
        """Scm: candidate camera -> current camera similarity and its
        inlier count, or None; ``last_sim3_reason`` says how far it got."""
        tcfg = self.cfg.tracker
        P = m.point_capacity
        kf_kp_pt = m.kf_kp_pt.cpu().numpy()
        kf_kp_valid = m.kf_kp_valid.cpu().numpy()
        pt_valid = m.pt_valid.cpu().numpy()

        def kp_valid(k):
            a = kf_kp_pt[k]
            return kf_kp_valid[k] & (a >= 0) & pt_valid[np.clip(a, 0, P - 1)]

        v_cur, v_cand = kp_valid(cur), kp_valid(cand)
        v_cur_t, v_cand_t = self._t(v_cur), self._t(v_cand)
        d_cur, d_cand = m.kf_kp_desc[cur], m.kf_kp_desc[cand]
        matches = None
        if self.vocab is not None:
            # SearchByBoW: features compared only under the same
            # direct-index node
            w1, _ = transform(self.vocab, d_cur, v_cur_t)
            w2, _ = transform(self.vocab, d_cand, v_cand_t)
            matches = match_descriptors_bow(
                d_cur, v_cur_t, direct_index_nodes(self.vocab, w1),
                d_cand, v_cand_t, direct_index_nodes(self.vocab, w2)).cpu().numpy()
            if int((matches >= 0).sum()) < tcfg.loop_min_inliers:
                matches = None  # scarce seeds: widen to the global ratio test
        if matches is None:
            matches = match_descriptors(d_cur, v_cur_t, d_cand, v_cand_t).cpu().numpy()
        i1 = np.where(matches >= 0)[0]
        self.last_sim3_reason = f"matches={len(i1)}/[{int(v_cur.sum())},{int(v_cand.sum())}]"
        if len(i1) < 3:
            return None
        i2 = matches[i1]

        # every point-associated keypoint's map point in its own camera frame
        pts = m.pts.cpu().numpy()
        R_all, t_all = m.kf_R.cpu().numpy(), m.kf_t.cpu().numpy()
        x1_all = (pts[np.clip(kf_kp_pt[cur], 0, P - 1)] @ R_all[cur].T + t_all[cur]
                  ).astype(np.float32)
        x2_all = (pts[np.clip(kf_kp_pt[cand], 0, P - 1)] @ R_all[cand].T + t_all[cand]
                  ).astype(np.float32)
        kp_xy = m.kf_kp_xy[[cur, cand]].cpu().numpy()
        uv1_all, uv2_all = kp_xy[0], kp_xy[1]

        def pack(ii, jj):
            n = min(len(ii), _SIM3_CAP)
            X1 = np.zeros((_SIM3_CAP, 3), np.float32)
            X2 = np.zeros((_SIM3_CAP, 3), np.float32)
            U1 = np.zeros((_SIM3_CAP, 2), np.float32)
            U2 = np.zeros((_SIM3_CAP, 2), np.float32)
            V = np.zeros(_SIM3_CAP, bool)
            X1[:n], X2[:n] = x1_all[ii[:n]], x2_all[jj[:n]]
            U1[:n], U2[:n] = uv1_all[ii[:n]], uv2_all[jj[:n]]
            V[:n] = True
            return X1, X2, U1, U2, V, n

        X1, X2, U1, U2, V, n = pack(i1, i2)
        # the metric RANSAC gate, relative to the scene's depth
        tol = 0.05 * float(np.median(np.linalg.norm(X1[:n], axis=-1)) + 1e-6)
        self._key_counter += 1
        res = ransac_sim3(self._t(X1), self._t(X2), self._t(V),
                          self._uniforms((SIM3_RANSAC_ITERATIONS, 3)), tol=tol,
                          min_inliers=min(tcfg.loop_min_inliers, 6))
        ok = bool(res.ok)
        self.last_sim3_reason += f" ransac_ok={ok}({int(res.n_inliers)})"
        if not ok:
            return None

        # grow the correspondences under the estimate and refine, twice (the
        # second round catches matches the coarse RANSAC estimate missed)
        g = res.g
        x1_t, x2_t = self._t(x1_all), self._t(x2_all)
        uv1_t, uv2_t = self._t(uv1_all), self._t(uv2_all)
        for _ in range(2):
            grown = _grow_sim3_matches(
                g, x1_t, v_cur_t, d_cur, uv1_t, m.kf_kp_octave[cur],
                x2_t, v_cand_t, d_cand, uv2_t, m.kf_kp_octave[cand],
                self.K, float(tcfg.loop_sim3_grow_radius_px), 100,
                self.scale_factor).cpu().numpy()
            j_for_i = np.full(len(matches), -1, np.int64)
            j_for_i[i1] = i2
            used2 = np.zeros(len(v_cand), bool)
            used2[i2] = True
            vac = (j_for_i < 0) & (grown >= 0) & ~used2[np.clip(grown, 0, len(v_cand) - 1)]
            j_for_i[vac] = grown[vac]
            ii = np.where(j_for_i >= 0)[0]
            self.last_sim3_reason += f" grown={len(ii)}"
            X1, X2, U1, U2, V, n = pack(ii, j_for_i[ii])
            g, inl = optimize_sim3(g, self._t(X1), self._t(X2), self._t(U1), self._t(U2),
                                   self.K, self._t(V))
            n_inl = int(inl.sum())
            self.last_sim3_reason += f" opt_inl={n_inl}/{tcfg.loop_min_inliers}"
            if n_inl >= tcfg.loop_min_inliers:
                return g, n_inl
        return None

    # ------------------------------------------------------------------
    def fuse_loop_points(self, m: SlamMap, group: Set[int], cand: int, R_corr: np.ndarray,
                         t_corr: np.ndarray, s_corr: np.ndarray) -> Tuple[SlamMap, int]:
        """SearchAndFuse: the loop side's points (those ``cand`` and its
        covisible keyframes observe) projected into each keyframe of the
        current group under its corrected pose; one landing within
        ``loop_fuse_radius_px`` of a keypoint at Hamming distance <= 50
        replaces that keypoint's point everywhere (observations, snapshot
        associations, validity, counts; a keyframe's duplicate observation
        rows of one merged point are dropped). One ``hamming_matrix``
        launch per group keyframe ([loop points padded to a power of two,
        keypoints]); the merges are numpy."""
        tcfg = self.cfg.tracker
        P = m.point_capacity
        pt_valid = m.pt_valid.cpu().numpy()
        obs_kf = m.obs_kf.cpu().numpy()
        obs_pt = m.obs_pt.cpu().numpy()
        obs_ok = m.obs_valid.cpu().numpy()

        cand_group = set(covisible_slots(m, cand, tcfg.covis_min_shared).tolist())
        cand_group.add(cand)
        in_cand = obs_ok & np.isin(obs_kf, sorted(cand_group))
        loop_mask = np.zeros(P, bool)
        loop_mask[obs_pt[in_cand]] = True
        loop_mask &= pt_valid
        loop_idx = np.where(loop_mask)[0]
        L = len(loop_idx)
        if L == 0:
            return m, 0
        Lcap = 1 << int(np.ceil(np.log2(max(L, 64))))
        pdesc = np.zeros((Lcap, 8), np.int32)
        pdesc[:L] = m.desc.cpu().numpy()[loop_idx]
        pdesc_dev = self._t(pdesc)

        fx, fy, cx, cy = self.K_np[0, 0], self.K_np[1, 1], self.K_np[0, 2], self.K_np[1, 2]
        pts = m.pts.cpu().numpy()[loop_idx]
        r2 = float(tcfg.loop_fuse_radius_px) ** 2
        kf_kp_xy = m.kf_kp_xy.cpu().numpy()
        kf_kp_valid = m.kf_kp_valid.cpu().numpy()
        kf_kp_pt = m.kf_kp_pt.cpu().numpy()

        merges: dict = {}   # duplicate slot -> loop slot
        for k in sorted(group):
            # corrected SE(3) projection: s (R X) + t is proportional to R X + t / s
            xc = pts @ R_corr[k].T + (t_corr[k] / max(s_corr[k], 1e-12))
            z = xc[:, 2]
            ok = z > 1e-6
            zs = np.where(ok, z, 1.0)
            u = fx * xc[:, 0] / zs + cx
            v = fy * xc[:, 1] / zs + cy
            D = hamming_matrix(pdesc_dev, m.kf_kp_desc[k]).cpu().numpy()[:L]   # [L, N]
            du = u[:, None] - kf_kp_xy[k][None, :, 0]
            dv = v[:, None] - kf_kp_xy[k][None, :, 1]
            good = (du * du + dv * dv <= r2) & kf_kp_valid[k][None, :] & ok[:, None] & (D <= 50)
            Dm = np.where(good, D, 999)
            j_best = Dm.argmin(axis=1)
            d_best = Dm.min(axis=1)
            for li in np.where(d_best <= 50)[0]:
                p = int(loop_idx[li])
                q = int(kf_kp_pt[k][j_best[li]])
                # only existing associations are replaced
                if q >= 0 and q != p and not loop_mask[q]:
                    merges[q] = p
        if not merges:
            return m, 0

        remap = np.arange(P, dtype=np.int64)
        for q, p in merges.items():
            remap[q] = p
        kfkp_new = np.where(kf_kp_pt >= 0, remap[np.clip(kf_kp_pt, 0, P - 1)],
                            kf_kp_pt).astype(kf_kp_pt.dtype)
        new_obs_pt = remap[obs_pt].astype(obs_pt.dtype)
        # one observation row per (keyframe, point) pair after the merge
        targets = np.unique(np.fromiter(merges.values(), np.int64))
        new_obs_ok = obs_ok.copy()
        aff = np.where(obs_ok & np.isin(new_obs_pt, targets))[0]
        if len(aff):
            keys = obs_kf[aff].astype(np.int64) * P + new_obs_pt[aff].astype(np.int64)
            _, first = np.unique(keys, return_index=True)
            dup = np.ones(len(aff), bool)
            dup[first] = False
            new_obs_ok[aff[dup]] = False
        n_obs = m.n_obs.cpu().numpy().copy()
        new_valid = pt_valid.copy()
        for q in merges:
            n_obs[q] = 0
            new_valid[q] = False
        for p in targets:
            n_obs[p] = int(np.sum(new_obs_ok & (new_obs_pt == p)))
        return m._replace(obs_pt=self._t(new_obs_pt), obs_valid=self._t(new_obs_ok),
                          kf_kp_pt=self._t(kfkp_new), pt_valid=self._t(new_valid),
                          n_obs=self._t(n_obs)), len(merges)

    # ------------------------------------------------------------------
    def correct(self, m: SlamMap, cur: int, cand: int, Scm: Sim3) -> Tuple[SlamMap, dict]:
        """CorrectLoop: see the module docstring, stage 3."""
        tcfg = self.cfg.tracker
        Kc = m.kf_capacity
        dev = self.device
        kf_valid = m.kf_valid.cpu().numpy()
        frame_ids = m.kf_frame_id.cpu().numpy()
        R_all = m.kf_R.cpu().numpy()
        t_all = m.kf_t.cpu().numpy()
        one = torch.ones((), dtype=torch.float32, device=dev)

        S_pre = Sim3(s=torch.ones(Kc, dtype=torch.float32, device=dev), R=m.kf_R, t=m.kf_t)
        S_cw_corr = sim3_compose(Scm, Sim3(s=one, R=m.kf_R[cand], t=m.kf_t[cand]))
        inv_cw_old = sim3_inverse(Sim3(s=one, R=m.kf_R[cur], t=m.kf_t[cur]))

        group = set(covisible_slots(m, cur, tcfg.covis_min_shared).tolist())
        group.add(cur)
        group = {g for g in group if kf_valid[g]}

        # vertex init: pre-correction everywhere, corrected for the group
        gsl = sorted(group)
        gi = self._t(np.asarray(gsl, np.int64))
        S_g = Sim3(s=one.expand(len(gsl)), R=m.kf_R[gi], t=m.kf_t[gi])
        S_corr = sim3_compose(sim3_compose(S_g, inv_cw_old), S_cw_corr)
        s_init = np.ones(Kc, np.float32)
        R_init = R_all.copy()
        t_init = t_all.copy()
        s_init[gsl] = S_corr.s.cpu().numpy()
        R_init[gsl] = S_corr.R.cpu().numpy()
        t_init[gsl] = S_corr.t.cpu().numpy()
        S_init = Sim3(s=self._t(s_init), R=self._t(R_init), t=self._t(t_init))

        # covisibility before the fuse: those pairs' relatives are odometry,
        # measured from the pre-correction poses
        shared_pre = covisibility_matrix(m)
        m, n_fused = self.fuse_loop_points(m, group, cand, R_init, t_init, s_init)

        # essential graph: the temporal chain, strong pre-existing
        # covisibility, the covisibility the fuse created (measured from the
        # hybrid S_init: they encode the closure) and the loop edge
        th_cov = tcfg.loop_covis_edge_min_shared
        order = [int(k) for k in np.argsort(frame_ids) if kf_valid[k]]
        ei: List[int] = []
        ej: List[int] = []
        for a, b in zip(order[1:], order[:-1]):
            ei.append(a)
            ej.append(b)
        ii, jj = np.where(np.triu(shared_pre, 1) >= th_cov)
        for a, b in zip(ii.tolist(), jj.tolist()):
            if kf_valid[a] and kf_valid[b] and abs(int(frame_ids[a]) - int(frame_ids[b])) > 1:
                ei.append(int(a))
                ej.append(int(b))
        E_odo = len(ei)
        shared_post = covisibility_matrix(m)
        ii, jj = np.where(np.triu(shared_post, 1) >= th_cov)
        for a, b in zip(ii.tolist(), jj.tolist()):
            if (shared_pre[a, b] < th_cov and kf_valid[a] and kf_valid[b]
                    and not (a == cur and b == cand) and not (a == cand and b == cur)):
                ei.append(int(a))
                ej.append(int(b))
        ei.append(cur)
        ej.append(cand)

        E = len(ei)
        cap = 1 << int(np.ceil(np.log2(max(E, 8))))   # padded to a power of two
        eia = self._t(np.asarray(ei + [0] * (cap - E), np.int64))
        eja = self._t(np.asarray(ej + [0] * (cap - E), np.int64))
        idx = torch.arange(cap, device=dev)
        meas_pre = relative_sim3(Sim3(*(x[eia] for x in S_pre)), Sim3(*(x[eja] for x in S_pre)))
        meas_cor = relative_sim3(Sim3(*(x[eia] for x in S_init)),
                                 Sim3(*(x[eja] for x in S_init)))
        closure = (idx >= E_odo) & (idx < E)
        loop_edge = idx == E - 1
        pad = idx >= E
        eye = torch.eye(3, dtype=torch.float32, device=dev)

        def pick(pre, cor, scm, ident, extra):
            sel = lambda c: c.view((-1,) + (1,) * extra)  # noqa: E731
            x = torch.where(sel(closure), cor, pre)
            x = torch.where(sel(loop_edge), scm, x)
            return torch.where(sel(pad), ident, x)

        meas = Sim3(s=pick(meas_pre.s, meas_cor.s, Scm.s, one, 0),
                    R=pick(meas_pre.R, meas_cor.R, Scm.R, eye, 2),
                    t=pick(meas_pre.t, meas_cor.t, Scm.t, torch.zeros_like(Scm.t), 1))
        e_w = (~pad).to(torch.float32)
        fixed = np.zeros(Kc, bool)
        fixed[cand] = True
        res = optimize_pose_graph(S_init, self._t(kf_valid), self._t(fixed), eia, eja, meas,
                                  e_w, iterations=tcfg.pose_graph_iterations)
        S_opt = res.vertices

        # write back: poses as [R, t/s]; each point moved by its reference
        # keyframe's total correction S_opt^-1 o S_pre
        s_opt = S_opt.s.cpu().numpy()
        R_opt = S_opt.R.cpu().numpy()
        t_opt = S_opt.t.cpu().numpy()
        new_R = np.where(kf_valid[:, None, None], R_opt, R_all)
        new_t = np.where(kf_valid[:, None], t_opt / np.maximum(s_opt[:, None], 1e-12), t_all)

        # the reference keyframe of a point: its valid observation with the
        # least frame id (MapPoint::mpRefKF)
        obs_kf = m.obs_kf.cpu().numpy()
        obs_pt = m.obs_pt.cpu().numpy()
        pt_valid = m.pt_valid.cpu().numpy()
        obs_ok = m.obs_valid.cpu().numpy() & kf_valid[obs_kf] & pt_valid[obs_pt]
        P = m.point_capacity
        big = np.int64(1 << 60)
        keyed = np.where(obs_ok, frame_ids[obs_kf].astype(np.int64) * P
                         + obs_kf.astype(np.int64), big)
        ref_key = np.full(P, big, np.int64)
        np.minimum.at(ref_key, obs_pt, keyed)
        has_ref = ref_key < big
        ref_kf = (ref_key % P).astype(np.int64)
        ref_kf[~has_ref] = 0
        ref = self._t(ref_kf)
        corr = sim3_compose(sim3_inverse(Sim3(*(x[ref] for x in S_opt))),
                            Sim3(*(x[ref] for x in S_pre)))
        moved = corr.s[:, None] * (corr.R @ m.pts[..., None])[..., 0] + corr.t
        do_move = self._t(has_ref) & m.pt_valid
        m = m._replace(kf_R=self._t(new_R.astype(np.float32)),
                       kf_t=self._t(new_t.astype(np.float32)),
                       pts=torch.where(do_move[:, None], moved, m.pts))
        self._groups.clear()
        self.last_closed_frame_id = int(frame_ids[cur])
        return m, {"loop_edges": E, "loop_fused": n_fused, "loop_cost0": float(res.cost0),
                   "loop_cost": float(res.cost)}

    # ------------------------------------------------------------------
    def on_keyframe(self, m: SlamMap, kf_db: KeyframeDatabase, slot: int
                    ) -> Tuple[SlamMap, dict]:
        """The whole pipeline after the insert of keyframe ``slot``; -> the
        (possibly corrected) map and the event's metrics."""
        tcfg = self.cfg.tracker
        cur_fid = int(m.kf_frame_id[slot])
        if cur_fid - self.last_closed_frame_id < tcfg.loop_min_frame_gap:
            return m, {"loop": "cooldown"}
        cands = self.detect(m, kf_db, slot)
        implicit = ({"loop_implicit_revisit": self.last_implicit_revisit}
                    if self.last_implicit_revisit else {})
        if not cands:
            return m, {"loop": "no candidate", **implicit}
        sim3 = None
        reasons = []
        for cand in cands[:tcfg.loop_max_sim3_candidates]:
            sim3 = self.compute_sim3(m, slot, cand)
            if sim3 is not None:
                break
            reasons.append(f"{cand}[{self.last_sim3_reason}]")
        if sim3 is None:
            return m, {"loop": "candidates rejected by Sim(3): " + "; ".join(reasons),
                       **implicit}
        Scm, n_inl = sim3
        m, info = self.correct(m, slot, cand, Scm)
        info.update({"loop": f"closed with kf {cand}", "loop_inliers": n_inl,
                     "loop_scale": float(Scm.s)})
        if tcfg.loop_global_ba_iterations > 0:
            m, gba = self.global_ba(m)
            info.update(gba)
        return m, info

    # ------------------------------------------------------------------
    def global_ba(self, m: SlamMap) -> Tuple[SlamMap, dict]:
        """RunGlobalBundleAdjustment: the scatter BA over the whole map,
        every valid keyframe free but the oldest (the gauge)."""
        tcfg = self.cfg.tracker
        kf_valid = m.kf_valid.cpu().numpy()
        fids = m.kf_frame_id.cpu().numpy()
        fixed = ~kf_valid
        vs = np.where(kf_valid)[0]
        if len(vs) == 0:
            return m, {}
        fixed[vs[np.argmin(fids[vs])]] = True
        res = bundle_adjust(
            m.kf_R, m.kf_t, m.pts, m.obs_kf, m.obs_pt, m.obs_uv, m.obs_inv_sigma2,
            m.obs_valid, self._t(fixed), m.pt_valid, self.K,
            iterations=tcfg.loop_global_ba_iterations, max_free_cams=None,
            early_stop_rel=tcfg.ba_early_stop_rel)
        return apply_ba_result(m, res), {"gba_cost0": float(res.cost0),
                                         "gba_cost": float(res.cost),
                                         "gba_inlier_obs": int(res.obs_inlier.sum())}
