"""Device-side local mapping (counterpart of ``slam/device_mapping.py``):
the whole keyframe slice as tensor functions of the fixed-capacity
``SlamMap``, and the tracking loop that runs it frame after frame.

Every local-mapping stage of a keyframe insert runs on the device with no
host read:

  allocate-or-evict keyframe slot    (redundancy eviction, masked)
  pose + keypoint snapshot write
  tracked-point observation append   (mask compaction, dropped padding)
  covisibility neighbour selection   (association matrix + stable top-k)
  epipolar triangulation + vetting   (``covis_match_triangulate``)
  create-time fusion                 (projection + Hamming duplicate check)
  point / keyframe culling           (full-array lifecycle masks)
  local bundle adjustment            (windowed Schur LM)
  viewing-statistics refresh

The JAX module writes the sequence as one ``lax.scan`` with two
``lax.cond``s a frame. Here the scan is a Python loop of fixed-shape
steps and each ``cond`` is a Python branch on one host read: whether the
tracking step held (``good0``, read together with the keyframe decision
that follows from it) and, after the LOST-recovery tier, whether a
keyframe is due. A frame that tracks reads the host once; a frame that
takes the recovery tier twice. The index sets of the insert are built on
the device (``_compact``), so the insert reads nothing on the host for
them.

Index conventions, as in ``slam/tracker.py``: a lane that the JAX scatter
drops (``mode="drop"``) goes to a spare slot past the end, which is sliced
off; a keyframe slot is a 1-element int64 tensor (a 0-d tensor as an index
would be read on the host). ``jax.lax.top_k`` puts the lower index first
among equal values, and ``torch.topk`` promises no order, so every top-k
here is a stable descending sort.

The differences from the host tracker are the JAX module's: a frame that
fails the inlier gate takes the LOST-recovery tier in the loop (a wide
re-match of the same frame's keypoints from the last good pose and a
widened-basin pose LM, then the narrow re-match and LM, kept only if it
holds at least the wide stage's inliers), and the neighbours are fused in
order, each against the map as the earlier ones left it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..ops.hamming import hamming_matrix
from ..ops.proj_matcher import search_by_projection
from ..optim.ba import bundle_adjust
from ..optim.pose_opt import optimize_pose
from .fused_step import TrackingStep
from .map import SlamMap, apply_ba_result, update_normal_and_depth
from .tracker import covis_match_triangulate, remove_kf, scatter_new_points, scatter_obs, write_kf

__all__ = ["DeviceLoopOutputs", "DeviceSequenceLoop", "make_device_insert_keyframe",
           "make_device_sequence_loop"]

_BIG = 1 << 30


def _compact(mask: torch.Tensor, cap: int):
    """The first ``cap`` set lanes of ``mask [N]`` -> (indices [cap] int32,
    N where padding, ok [cap] bool)."""
    n = mask.shape[0]
    rank = torch.cumsum(mask.to(torch.int32), 0) - 1
    tgt = torch.where(mask & (rank < cap), rank, cap)
    lanes = torch.full((cap + 1,), n, dtype=torch.int32, device=mask.device)
    lanes.scatter_(0, tgt.long(), torch.arange(n, dtype=torch.int32, device=mask.device))
    ok = torch.arange(cap, device=mask.device) < mask.sum(dtype=torch.int32).clamp_max(cap)
    return lanes[:cap], ok


def _top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` of a 1-D ``x``: the k largest, the lower index
    first among equal values."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _row(x: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``x[slot]`` for a 1-element index tensor."""
    return x[slot][0]


def _kf_redundancy(m: SlamMap) -> torch.Tensor:
    """Per keyframe slot, the fraction of its observed points seen by >= 4
    keyframes (the host tracker's ``_kf_redundancy``). The counts are
    integer sums, so they repeat exactly."""
    okf = m.obs_kf.long()
    red = m.obs_valid & (m.n_obs[m.obs_pt.long()] >= 4)
    zero = torch.zeros(m.kf_capacity, dtype=torch.int32, device=okf.device)
    tot = zero.index_add(0, okf, m.obs_valid.to(torch.int32)).to(torch.float32)
    hit = zero.index_add(0, okf, red.to(torch.int32)).to(torch.float32)
    return hit / tot.clamp_min(1.0)


def _oldest(m: SlamMap) -> torch.Tensor:
    """The valid keyframe of least frame id (the gauge anchor), [1]."""
    return torch.argmin(torch.where(m.kf_valid, m.kf_frame_id, _BIG)).view(1)


def _protected_mask(m: SlamMap) -> torch.Tensor:
    """Never culled or evicted: the oldest keyframe and the two most recent."""
    fids = torch.where(m.kf_valid, m.kf_frame_id, -1)
    _, recent = _top_k(fids, 2)
    prot = torch.zeros(m.kf_capacity, dtype=torch.bool, device=fids.device)
    prot = prot.index_put((recent,), fids[recent] >= 0)
    return prot.index_fill(0, _oldest(m), True)


def _cull_points(m: SlamMap, kf_count: int, tcfg: TrackerConfig) -> SlamMap:
    """MapPointCulling over every slot at once."""
    age = kf_count - m.pt_birth_kf
    bad = m.pt_valid & (
        ((age >= tcfg.cull_age_kfs) & (m.n_obs < tcfg.cull_min_obs))
        | ((m.pt_visible >= tcfg.cull_min_visible)
           & (m.pt_found.to(torch.float32)
              < tcfg.cull_found_ratio * m.pt_visible.to(torch.float32))))
    snap = m.kf_kp_pt
    snap_bad = bad[snap.clamp_min(0).long()] & (snap >= 0)
    return m._replace(pt_valid=m.pt_valid & ~bad,
                      obs_valid=m.obs_valid & ~bad[m.obs_pt.long()],
                      kf_kp_pt=torch.where(snap_bad, -1, snap))


def _cull_keyframes(m: SlamMap, tcfg: TrackerConfig) -> SlamMap:
    """KeyFrameCulling: the most redundant unprotected keyframe with >= 10
    observations, when >= ``kf_redundancy_frac`` of its points are seen by
    >= 4 keyframes, is removed; at most one, and none when there is no
    candidate (the removal is then sent to the spare slot)."""
    counts = torch.zeros(m.kf_capacity, dtype=torch.int32, device=m.obs_kf.device).index_add(
        0, m.obs_kf.long(), m.obs_valid.to(torch.int32))
    red = _kf_redundancy(m)
    cand = m.kf_valid & ~_protected_mask(m) & (counts >= 10) & (red >= tcfg.kf_redundancy_frac)
    victim = torch.argmax(torch.where(cand, red, -torch.inf)).view(1)
    return remove_kf(m, torch.where(cand.any(), victim, m.kf_capacity))


def make_device_insert_keyframe(cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                                matcher_cfg: MatcherConfig, tcfg: TrackerConfig,
                                tri_cap: int = 256, obs_cap: int = 512):
    """Build the keyframe insert.

    ``insert(m, R, t, K, frame_id: int, kf_count: int, kp_desc [N,8],
    kp_oct [N], kp_ang [N], kp_valid [N], xy_un [N,2], kp_for_point [P],
    inlier [P]) -> (m', slot [1] int64, n_tracked_obs + n_new [] int32)``;
    ``frame_id`` and ``kf_count`` are host ints, everything else tensors on
    the map's device."""
    if tcfg.ba_segment_mode not in ("auto", "scatter"):
        raise ValueError(f"ba_segment_mode {tcfg.ba_segment_mode!r}: the port has the "
                         "scatter formulation only ('auto' or 'scatter')")
    NB = tcfg.covis_keyframes
    scale = orb_cfg.scale_factor
    fuse_r2 = float(tcfg.fuse_radius_px) ** 2

    def inv_sigma2(octave):
        return 1.0 / scale ** (2.0 * octave.to(torch.float32))

    def insert(m: SlamMap, R, t, K, frame_id: int, kf_count: int, kp_desc, kp_oct, kp_ang,
               kp_valid, xy_un, kp_for_point, inlier):
        P, N, Kc = m.point_capacity, m.kp_capacity, m.kf_capacity
        O = m.obs_kf.shape[0]
        dev = m.pts.device
        if kp_valid.shape[0] > N:
            raise ValueError(f"keypoint count {kp_valid.shape[0]} exceeds the map's "
                             f"snapshot capacity {N}")

        # slot: the first free one, else evict the most redundant
        # unprotected keyframe (its removal sent to the spare slot when
        # one is free)
        free = ~m.kf_valid
        any_free = free.any()
        evict = torch.where(m.kf_valid & ~_protected_mask(m), _kf_redundancy(m), -torch.inf)
        slot = torch.where(any_free, torch.argmax(free.to(torch.int32)),
                           torch.argmax(evict)).view(1)
        m = remove_kf(m, torch.where(any_free, Kc, slot))

        # pose and keypoint snapshot
        n_kp = kp_valid.shape[0]
        tracked = inlier & (kp_for_point >= 0) & m.pt_valid                    # [P]
        kp_pt = torch.full((n_kp + 1,), -1, dtype=torch.int32, device=dev)
        kp_pt.scatter_(0, torch.where(tracked, kp_for_point, n_kp).long(),
                       torch.arange(P, dtype=torch.int32, device=dev))
        m = write_kf(m, slot, kp_desc, kp_oct, kp_ang, kp_valid, xy_un, kp_pt[:n_kp],
                     R, t, frame_id)
        cur_xy, cur_oct = _row(m.kf_kp_xy, slot), _row(m.kf_kp_octave, slot)
        cur_desc = _row(m.kf_kp_desc, slot)

        # tracked-point observations
        pt_lane, ok_t = _compact(tracked, obs_cap)
        rows_t, _ = _compact(~m.obs_valid, obs_cap)
        kp_t = kp_for_point[pt_lane.clamp(0, P - 1).long()]
        kp_safe = kp_t.clamp(0, N - 1).long()
        ok_t = ok_t & (rows_t < O)
        n_tracked = ok_t.sum(dtype=torch.int32)
        m = scatter_obs(m, slot, rows_t, pt_lane, kp_t, cur_xy[kp_safe],
                        inv_sigma2(cur_oct[kp_safe]), ok_t, 0)

        # covisibility: the keyframes sharing the most of this one's points
        col = torch.where((m.kf_kp_pt >= 0) & m.kf_kp_valid, m.kf_kp_pt, P).long()
        A = torch.zeros((Kc, P + 1), dtype=torch.bool, device=dev).scatter_(1, col, True)[:, :P]
        cur_vec = _row(A, slot) & m.pt_valid
        shared = (A & cur_vec).sum(dim=1, dtype=torch.int32)
        kf_ids = torch.arange(Kc, device=dev)
        shared = torch.where(m.kf_valid & (kf_ids != slot), shared, -1)
        nb_shared, nb_idx = _top_k(shared, NB)
        nb_ok = nb_shared >= tcfg.covis_min_shared
        # fallback: the best-sharing keyframe alone (host parity)
        nb_ok = nb_ok | ((torch.arange(NB, device=dev) == 0) & (nb_shared > 0) & ~nb_ok.any())

        # batched match + triangulate + vet over the neighbour axis
        cur_kp_pt = _row(m.kf_kp_pt, slot)
        R_cur, t_cur = _row(m.kf_R, slot), _row(m.kf_t, slot)
        nb_valid = m.kf_kp_valid[nb_idx] & (m.kf_kp_pt[nb_idx] < 0) & nb_ok[:, None]
        m12_b, pts_b, vet_b = covis_match_triangulate(
            m.kf_kp_desc[nb_idx], m.kf_kp_xy[nb_idx], m.kf_kp_octave[nb_idx],
            m.kf_kp_angle[nb_idx], nb_valid,
            cur_desc, cur_xy, cur_oct, _row(m.kf_kp_angle, slot),
            _row(m.kf_kp_valid, slot) & (cur_kp_pt < 0),
            m.kf_R[nb_idx], m.kf_t[nb_idx], R_cur, t_cur, K, matcher_cfg, scale)

        # sequential per-neighbour fusion and creation (host parity)
        consumed = torch.zeros(N + 1, dtype=torch.bool, device=dev)
        n_created = torch.zeros((), dtype=torch.int32, device=dev)
        for b in range(NB):
            nb = nb_idx[b:b + 1]
            m12 = m12_b[b]
            i2s = m12.clamp_min(0).long()
            okb = vet_b[b] & ~consumed[i2s] & nb_ok[b]

            # the fuse check against the map as the earlier neighbours left it
            pc = m.pts @ R_cur.T + t_cur
            z = pc[:, 2]
            zi = torch.where(z.abs() < 1e-9, 1e-9, z)
            u = K[0, 0] * pc[:, 0] / zi + K[0, 2]
            v = K[1, 1] * pc[:, 1] / zi + K[1, 2]
            proj_ok = m.pt_valid & (z > 0.05)
            x2 = cur_xy[i2s]                                                  # [N, 2]
            d2 = (x2[:, 0:1] - u) ** 2 + (x2[:, 1:2] - v) ** 2                 # [N, P]
            hd = hamming_matrix(cur_desc[i2s], m.desc)
            Dm = torch.where((d2 <= fuse_r2) & proj_ok, hd, 999)
            fuse_tgt = torch.argmin(Dm, dim=1)
            fuse_hit = okb & (Dm.gather(1, fuse_tgt[:, None])[:, 0] <= matcher_cfg.th_low)

            # fused lanes -> extra observations of the existing point
            fl, fok = _compact(fuse_hit, tri_cap)
            kp2_f = i2s[fl.clamp(0, N - 1).long()]
            rows_f, _ = _compact(~m.obs_valid, tri_cap)
            fok = fok & (rows_f < O)
            m = scatter_obs(m, slot, rows_f, fuse_tgt[fl.clamp(0, N - 1).long()], kp2_f,
                            cur_xy[kp2_f], inv_sigma2(cur_oct[kp2_f]), fok, 1)

            # new points
            nl, nok = _compact(okb & ~fuse_hit, tri_cap)
            nls = nl.clamp(0, N - 1).long()
            kp2_n = i2s[nls]
            pslots, pok = _compact(~m.pt_valid, tri_cap)
            rows, _ = _compact(~m.obs_valid, 2 * tri_cap)
            rows1, rows2 = rows[:tri_cap], rows[tri_cap:]
            nok = nok & pok & (rows1 < O) & (rows2 < O)
            nb_xy, nb_oct = _row(m.kf_kp_xy, nb), _row(m.kf_kp_octave, nb)
            birth = torch.full((tri_cap,), kf_count, dtype=torch.int32, device=dev)
            m = scatter_new_points(
                m, slot, nb, pslots, rows1, rows2, nl, kp2_n, pts_b[b][nls],
                nb_xy[nls], cur_xy[kp2_n], inv_sigma2(nb_oct[nls]), inv_sigma2(cur_oct[kp2_n]),
                birth, nok)
            n_created = n_created + nok.sum(dtype=torch.int32)
            consumed = consumed.index_fill(0, torch.where(okb, m12, N).long(), True)

        # lifecycle culling
        m = _cull_points(m, kf_count + 1, tcfg)
        m = _cull_keyframes(m, tcfg)

        # local BA over the `ba_window` most recent keyframes, the oldest fixed
        fids = torch.where(m.kf_valid, m.kf_frame_id, -1)
        _, widx = _top_k(fids, min(tcfg.ba_window, Kc))
        in_window = torch.zeros(Kc, dtype=torch.bool, device=dev).index_put(
            (widx,), fids[widx] >= 0)
        fixed = (~in_window | ~m.kf_valid).index_fill(0, _oldest(m), True)
        res = bundle_adjust(
            m.kf_R, m.kf_t, m.pts, m.obs_kf, m.obs_pt, m.obs_uv, m.obs_inv_sigma2,
            m.obs_valid, fixed, m.pt_valid, K, iterations=tcfg.ba_iterations,
            max_free_cams=tcfg.ba_window, early_stop_rel=tcfg.ba_early_stop_rel)
        m = apply_ba_result(m, res)
        m = update_normal_and_depth(m, scale, orb_cfg.n_levels)
        return m, slot, n_tracked + n_created

    return insert


class DeviceLoopOutputs(NamedTuple):
    R: torch.Tensor            # [(B,) T, 3, 3]
    t: torch.Tensor            # [(B,) T, 3]
    n_inliers: torch.Tensor    # [(B,) T] int32
    n_kps: torch.Tensor        # [(B,) T] int32
    inserted_kf: torch.Tensor  # [(B,) T] bool
    lost: torch.Tensor         # [(B,) T] bool


def _index_batch(tree, b):
    """Row ``b`` (an int or an index tensor) of every tensor of a NamedTuple
    with a leading batch axis, e.g. one sequence's ``SlamMap``."""
    return type(tree)(*(x[b] if isinstance(x, torch.Tensor) else _index_batch(x, b)
                        for x in tree))


def _matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``M [..., 3, 3] @ v [..., 3]`` per batch row (one vector: ``mv``)."""
    return M @ v if v.dim() == 1 else (M @ v[..., None])[..., 0]


class DeviceSequenceLoop:
    """Whole-sequence tracking with the keyframe lifecycle, frame after
    frame on the device (see the module docstring).

    ``loop(images [T, H, W], m0, R0 [3,3], t0 [3], K [3,3], frame_id0: int,
    kf_count0: int, kf_ref_inliers0) -> (final SlamMap, DeviceLoopOutputs)``.
    The initial map comes from a bootstrap (the port's ``Tracker`` until
    WORKING). A leading [B] on ``images``, every field of ``m0``, ``R0``
    and ``t0``, with B ints for ``frame_id0``, ``kf_count0`` and
    ``kf_ref_inliers0``, runs B sequences at once (``K`` shared), and every
    output then has it: the tracking step runs batched, and the recovery
    tier and the keyframe insert per sequence on its rows of the map (the
    multi-sequence mapping runner, ``parallel.multiseq``). One sequence
    takes the same frame loop with the step unbatched, its tensors seen as
    a batch of one where a row is read or written, so that its results
    stay those of the single-sequence step bit for bit (a step batched at
    B = 1 sums its pose LM in another order). ``step``, ``recover`` and
    ``insert`` are attributes, so
    a profiler can wrap each stage. ``batched_solve`` takes the pose LMs'
    6x6 steps in closed form (``optim.lm.solve_spd6``), as the JAX loop
    under its multi-sequence runner."""

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: OrbConfig, matcher_cfg: MatcherConfig,
                 tcfg: TrackerConfig, tri_cap: int = 256, obs_cap: int = 512,
                 batched_solve: bool = False, device: torch.device | str = DEFAULT_DEVICE):
        self.batched_solve = batched_solve
        self.cam_cfg, self.orb_cfg, self.matcher_cfg, self.tcfg = (
            cam_cfg, orb_cfg, matcher_cfg, tcfg)
        self.device = resolve_device(device)
        self.step = TrackingStep(cam_cfg, orb_cfg, matcher_cfg, tcfg,
                                 batched_solve=batched_solve, device=self.device)
        self.insert = make_device_insert_keyframe(cam_cfg, orb_cfg, matcher_cfg, tcfg,
                                                  tri_cap, obs_cap)

    def recover(self, m: SlamMap, r, R, t, K):
        """The LOST-recovery tier for a frame whose step failed: stage 1, a
        wide re-match from the last good pose and the pose LM with a widened
        Huber basin; stage 2, the narrow re-match from that pose and the
        standard LM, kept only if it holds at least stage 1's inliers. ->
        (R, t, n_inliers, kp_for_point, inlier, visible)."""
        cam, ocfg, tcfg = self.cam_cfg, self.orb_cfg, self.tcfg
        scale = ocfg.scale_factor

        def stage(R0, t0, radius, **kw):
            pm = search_by_projection(
                m.pts, m.desc, m.pt_valid, R0, t0, K, r.kps.desc, r.xy_un, r.kps.valid,
                radius, self.matcher_cfg, cam.width, cam.height, kp_octave=r.kps.octave,
                scale_factor=scale, pt_normal=m.pt_normal, pt_dmin=m.pt_dmin,
                pt_dmax=m.pt_dmax, n_levels=ocfg.n_levels)
            safe = pm.kp_for_point.clamp_min(0).long()
            inv_s2 = 1.0 / scale ** (2.0 * r.kps.octave[safe].to(torch.float32))
            res = optimize_pose(R0, t0, m.pts, r.xy_un[safe], inv_s2, pm.kp_for_point >= 0, K,
                                rounds=tcfg.pose_opt_rounds, iters_per_round=tcfg.pose_opt_iters,
                                batched_solve=self.batched_solve, **kw)
            return pm, res

        pmw, resw = stage(R, t, tcfg.projection_radius * tcfg.lost_recovery_radius_scale,
                          coarse_delta_scale=25.0)
        pmn, resn = stage(resw.R, resw.t, tcfg.projection_radius)
        ok2 = resn.n_inliers >= resw.n_inliers
        return (torch.where(ok2, resn.R, resw.R), torch.where(ok2, resn.t, resw.t),
                torch.where(ok2, resn.n_inliers, resw.n_inliers),
                torch.where(ok2, pmn.kp_for_point, pmw.kp_for_point),
                torch.where(ok2, resn.inlier, resw.inlier),
                torch.where(ok2, pmn.visible, pmw.visible))

    def __call__(self, images, m: SlamMap, R, t, K, frame_id0, kf_count0, kf_ref_inliers0):
        tcfg = self.tcfg
        lead = images.shape[:-3]  # (B,), or () for one sequence
        dev = m.pts.device

        def rows(x):
            """A batch view: one sequence's tensors as a batch of one."""
            if lead:
                return x
            return x[None] if isinstance(x, torch.Tensor) else _index_batch(x, None)

        m = SlamMap(*(x.clone() for x in m))  # the inserts write their rows in place
        vel_R = torch.eye(3, device=dev).expand(lead + (3, 3)).clone()
        vel_t = torch.zeros(lead + (3,), device=dev)
        have_vel = torch.zeros(lead, dtype=torch.bool, device=dev)
        ref_inl = torch.as_tensor(kf_ref_inliers0, dtype=torch.int32, device=dev).clone()
        fid = [int(x) for x in (frame_id0 if lead else [frame_id0])]
        kfc = [int(x) for x in (kf_count0 if lead else [kf_count0])]
        fsk = torch.zeros(lead, dtype=torch.int32, device=dev)  # frames since the last insert
        recovery = tcfg.lost_recovery_radius_scale > 0
        outs, inserted = [], []
        for image in images.unbind(len(lead)):
            use_vel = have_vel & tcfg.use_motion_model
            R_pred = torch.where(use_vel[..., None, None], vel_R @ R, R)
            t_pred = torch.where(use_vel[..., None], _matvec(vel_R, t) + vel_t, t)
            r = self.step(image, m.pts, m.desc, m.pt_valid, m.pt_normal, m.pt_dmin,
                          m.pt_dmax, R_pred, t_pred, R, t, K)
            fsk = fsk + 1
            good0_t = r.n_inliers >= tcfg.min_tracked_inliers

            def need_keyframe(good, n_inl):
                return (good & (fsk >= tcfg.min_frames + 1)
                        & ((fsk >= tcfg.max_frames)
                           | (n_inl.to(torch.float32) < 0.9 * ref_inl.to(torch.float32))
                           | (n_inl < tcfg.min_tracked_inliers * 5)))

            # one host read: which steps held, and where a keyframe is then due
            good0, need_kf = torch.stack(
                [good0_t, need_keyframe(good0_t, r.n_inliers)]).reshape(2, -1).tolist()
            R_opt, t_opt, n_inl = r.R, r.t, r.n_inliers
            kp_for_point, inlier, visible = r.kp_for_point, r.inlier, r.visible
            good = good0_t
            lost = [b for b, g in enumerate(good0) if not g] if recovery else []
            if lost:
                R_opt, t_opt, n_inl, kp_for_point, inlier, visible = (
                    x.clone() for x in (R_opt, t_opt, n_inl, kp_for_point, inlier, visible))
                dsts = [rows(x) for x in (R_opt, t_opt, n_inl, kp_for_point, inlier, visible)]
                for b in lost:
                    got = self.recover(_index_batch(rows(m), b), _index_batch(rows(r), b),
                                       rows(R)[b], rows(t)[b], K)
                    for dst, src in zip(dsts, got):
                        dst[b] = src
                good = n_inl >= tcfg.min_tracked_inliers
                # the second host read, for the recovered sequences
                due = need_keyframe(good, n_inl).reshape(-1).tolist()
                for b in lost:
                    need_kf[b] = due[b]
            # mnVisible / mnFound tallies (culling input, host parity)
            found = (kp_for_point >= 0) & m.pt_valid
            m = m._replace(pt_visible=m.pt_visible + (visible & m.pt_valid).to(torch.int32),
                           pt_found=m.pt_found + found.to(torch.int32))
            R_new = torch.where(good[..., None, None], R_opt, R)
            t_new = torch.where(good[..., None], t_opt, t)
            # velocity only from continuous good frames: a recovered pose
            # jumped, so its velocity is stale
            v_R = r.R @ R.transpose(-1, -2)
            vel_t = torch.where(good0_t[..., None], r.t - _matvec(v_R, t), vel_t)
            vel_R = torch.where(good0_t[..., None, None], v_R, vel_R)
            have_vel = good0_t | (have_vel & ~good)
            rb = rows(r)
            for b in (b for b, due in enumerate(need_kf) if due):
                m_b, _, support = self.insert(
                    _index_batch(rows(m), b), rows(R_new)[b], rows(t_new)[b], K, fid[b], kfc[b],
                    rb.kps.desc[b], rb.kps.octave[b], rb.kps.angle_deg[b], rb.kps.valid[b],
                    rb.xy_un[b], rows(kp_for_point)[b], rows(inlier)[b])
                for dst, src in zip(rows(m), m_b):
                    dst[b] = src
                # selects: writing a number into a device tensor (``[b] = 0``)
                # synchronizes with the host
                row_b = torch.arange(len(fid), device=dev).reshape(lead) == b
                ref_inl = torch.where(row_b, support, ref_inl)
                fsk = torch.where(row_b, 0, fsk)
                kfc[b] += 1
            R, t = R_new, t_new
            fid = [x + 1 for x in fid]
            outs.append((R_new, t_new, n_inl, r.n_kps, ~good))
            inserted.append(need_kf)
        R, t, n_inl, n_kps, lost = (torch.stack(x, dim=len(lead)) for x in zip(*outs))
        inserted_kf = torch.tensor(inserted, device=dev).reshape((-1,) + lead).movedim(0, -1)
        return m, DeviceLoopOutputs(R, t, n_inl, n_kps, inserted_kf, lost)


def make_device_sequence_loop(cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                              matcher_cfg: MatcherConfig, tcfg: TrackerConfig,
                              tri_cap: int = 256, obs_cap: int = 512,
                              batched_solve: bool = False,
                              device: torch.device | str = DEFAULT_DEVICE) -> DeviceSequenceLoop:
    """The sequence loop on ``device`` (the card unless ``device="cpu"``);
    ``batched_solve=True`` is the JAX package's multi-sequence form of the
    pose LM's solve."""
    return DeviceSequenceLoop(cam_cfg, orb_cfg, matcher_cfg, tcfg, tri_cap, obs_cap,
                              batched_solve, device)
