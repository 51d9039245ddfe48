"""The monocular tracking loop (counterpart of ``slam/tracker.py``): the
reference's unfinished ``Tracking`` class, completed.

- NO_IMAGES_YET / NOT_INITIALIZED -> the first frame with >= 100
  keypoints of the init-time extractor becomes the reference;
- INITIALIZING -> the init matcher and two-view bootstrap, then the map:
  two keyframes, median-depth scale normalisation and a BA over both;
- WORKING -> the fused tracking step under a constant-velocity prediction
  (``TrackingStep``; a 2x-radius retry below 20 matches), the
  visible/found tallies, and the keyframe policy. A keyframe insert runs
  covisibility triangulation with fusion, point and keyframe culling,
  slot eviction, local BA and the viewing statistics; when the projection
  match fails, the newest keyframe is matched by descriptor before LOST;
- LOST -> map-wide relocalization: descriptor matching of every map
  point, RANSAC PnP, pose LM, a tight re-match and LM again.

Control flow lives on the host and reads scalars there, as the JAX
package's does; every numeric stage runs on the tracker's device. The
random draws of initialization and relocalization come from one method,
``_uniforms``, on a ``torch.Generator`` seeded with 0.

BoW (reference-keyframe matching restricted to vocabulary nodes, BoW
relocalization) and loop closing are not ported yet: ``use_bow`` and
``use_loop_closing`` raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import SystemConfig
from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..geometry import camera
from ..geometry.fundamental import fundamental_from_poses
from ..geometry.pnp import ransac_pnp
from ..geometry.triangulate import triangulate_dlt
from ..geometry.twoview import initialize_two_view
from ..ops.extractor import ExtractorConstants, orb_extract
from ..ops.hamming import popcount
from ..ops.matcher import (
    compact_matches,
    match_descriptors,
    search_for_initialization,
    search_for_triangulation,
)
from ..ops.proj_matcher import search_by_projection
from ..optim.ba import bundle_adjust
from ..optim.pose_opt import optimize_pose
from ..types import Keypoints
from .fused_step import TrackingStep
from .map import SlamMap, apply_ba_result, empty_map, free_slots, update_normal_and_depth

__all__ = ["Tracker", "TrackState"]

# RANSAC hypotheses of a relocalization (as the JAX tracker draws)
RELOC_HYPOTHESES = 4096


class TrackState:
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    INITIALIZING = 2
    WORKING = 3
    LOST = 4

    NAMES = {0: "NO_IMAGES_YET", 1: "NOT_INITIALIZED", 2: "INITIALIZING",
             3: "WORKING", 4: "LOST"}


# ---------------------------------------------------------------------------
# map updates: pure tensor functions, each the counterpart of one jitted
# helper of the JAX module. The JAX scatters drop padding lanes sent to
# out-of-range indices (``mode="drop"``); here such lanes go to a spare row
# past the end, which is sliced off.

def _set(x: torch.Tensor, idx: torch.Tensor, vals, ok: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].set(vals)`` on axis 0 where ``ok``; other lanes dropped."""
    n = x.shape[0]
    buf = torch.cat([x, x[:1]])
    buf[torch.where(ok, idx.long(), n)] = vals.to(x.dtype) if torch.is_tensor(vals) else vals
    return buf[:n]


def _add(x: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
         ok: torch.Tensor) -> torch.Tensor:
    """``x.at[idx].add(vals)`` on axis 0 where ``ok``; other lanes dropped."""
    n = x.shape[0]
    buf = torch.cat([x, torch.zeros_like(x[:1])])
    return buf.index_add_(0, torch.where(ok, idx.long(), n), vals.to(x.dtype))[:n]


def _set2(x: torch.Tensor, row, col: torch.Tensor, vals, ok: torch.Tensor) -> torch.Tensor:
    """``x.at[row, col].set(vals)`` of a 2-D ``x`` where ``ok``."""
    flat = torch.as_tensor(row, device=col.device).long() * x.shape[1] + col.long()
    return _set(x.reshape(-1), flat, vals, ok).view(x.shape)


def scatter_obs(m: SlamMap, slot: int, rows, tgt, kp, uv, inv_s2, ok,
                add_stats: int) -> SlamMap:
    """Append observation rows (keyframe ``slot``, point ``tgt``, keypoint
    ``kp``, pixel, information) at ``rows`` where ``ok``; with
    ``add_stats`` 1 also count a found and visible frame for the point
    (fusion)."""
    okf = ok.to(torch.int32)
    return m._replace(
        obs_kf=_set(m.obs_kf, rows, slot, ok),
        obs_pt=_set(m.obs_pt, rows, tgt, ok),
        obs_kp=_set(m.obs_kp, rows, kp, ok),
        obs_uv=_set(m.obs_uv, rows, uv, ok),
        obs_inv_sigma2=_set(m.obs_inv_sigma2, rows, inv_s2, ok),
        obs_valid=_set(m.obs_valid, rows, True, ok),
        n_obs=_add(m.n_obs, tgt, okf, ok),
        kf_kp_pt=_set2(m.kf_kp_pt, slot, kp, tgt, ok),
        pt_found=_add(m.pt_found, tgt, okf * add_stats, ok),
        pt_visible=_add(m.pt_visible, tgt, okf * add_stats, ok),
    )


def scatter_new_points(m: SlamMap, slot: int, nb: int, pslots, rows1, rows2, kp1, kp2,
                       pts, uv1, uv2, inv1, inv2, birth, ok) -> SlamMap:
    """Create triangulated points at ``pslots`` where ``ok``, each with two
    observations (neighbour keyframe ``nb`` keypoint ``kp1``, current
    keyframe ``slot`` keypoint ``kp2``) and the current keyframe's
    descriptor."""
    N = m.kp_capacity
    desc = m.kf_kp_desc[slot][kp2.long().clamp(0, N - 1)]
    one = torch.ones_like(pslots, dtype=torch.int32)

    def two(x, v1, v2):
        return _set(_set(x, rows1, v1, ok), rows2, v2, ok)

    return m._replace(
        pts=_set(m.pts, pslots, pts, ok),
        desc=_set(m.desc, pslots, desc, ok),
        pt_valid=_set(m.pt_valid, pslots, True, ok),
        n_obs=_set(m.n_obs, pslots, 2 * one, ok),
        pt_birth_kf=_set(m.pt_birth_kf, pslots, birth, ok),
        pt_visible=_set(m.pt_visible, pslots, one, ok),
        pt_found=_set(m.pt_found, pslots, one, ok),
        obs_kf=two(m.obs_kf, nb, slot),
        obs_pt=two(m.obs_pt, pslots, pslots),
        obs_kp=two(m.obs_kp, kp1, kp2),
        obs_uv=two(m.obs_uv, uv1, uv2),
        obs_inv_sigma2=two(m.obs_inv_sigma2, inv1, inv2),
        obs_valid=two(m.obs_valid, True, True),
        kf_kp_pt=_set2(_set2(m.kf_kp_pt, nb, kp1, pslots, ok), slot, kp2, pslots, ok),
    )


def write_kf(m: SlamMap, slot: int, desc, octave, angle, valid, xy_un, kp_pt,
             R, t, frame_id: int) -> SlamMap:
    """Keyframe ``slot``'s pose and keypoint snapshot, padded to the map's
    keypoint capacity (association -1, validity False)."""
    pad = m.kp_capacity - valid.shape[0]

    def padded(x, fill=0):
        return torch.nn.functional.pad(x, (0, 0) * (x.dim() - 1) + (0, pad), value=fill)

    def at_slot(x, v):
        x = x.clone()
        x[slot] = v
        return x

    return m._replace(
        kf_R=at_slot(m.kf_R, R), kf_t=at_slot(m.kf_t, t),
        kf_valid=at_slot(m.kf_valid, True), kf_frame_id=at_slot(m.kf_frame_id, frame_id),
        kf_kp_xy=at_slot(m.kf_kp_xy, padded(xy_un)),
        kf_kp_desc=at_slot(m.kf_kp_desc, padded(desc)),
        kf_kp_octave=at_slot(m.kf_kp_octave, padded(octave)),
        kf_kp_angle=at_slot(m.kf_kp_angle, padded(angle)),
        kf_kp_valid=at_slot(m.kf_kp_valid, padded(valid)),
        kf_kp_pt=at_slot(m.kf_kp_pt, padded(kp_pt, -1)),
    )


def remove_kf(m: SlamMap, slot: int) -> SlamMap:
    """Invalidate keyframe ``slot``: drop its observations, decrement their
    points' observation counts, clear its snapshot's associations."""
    hit = m.obs_valid & (m.obs_kf == slot)
    dec = torch.zeros_like(m.n_obs).index_add_(0, m.obs_pt.long(), hit.to(torch.int32))
    kf_kp_pt = m.kf_kp_pt.clone()
    kf_kp_pt[slot] = -1
    kf_kp_valid = m.kf_kp_valid.clone()
    kf_kp_valid[slot] = False
    kf_valid = m.kf_valid.clone()
    kf_valid[slot] = False
    return m._replace(obs_valid=m.obs_valid & ~hit, n_obs=m.n_obs - dec,
                      kf_valid=kf_valid, kf_kp_pt=kf_kp_pt, kf_kp_valid=kf_kp_valid)


def triangulate_world(R1, t1, R2, t2, K, x1, x2) -> torch.Tensor:
    """Matched undistorted pixels ``x1, x2 [..., N, 2]`` of two
    world-to-camera poses (``R [..., 3, 3]``, ``t [..., 3]``) -> world
    points [..., N, 3] by DLT."""
    P1 = K @ torch.cat([R1, t1[..., None]], dim=-1)
    P2 = K @ torch.cat([R2, t2[..., None]], dim=-1)
    return triangulate_dlt(P1, P2, x1, x2)


def covis_match_triangulate(nb_desc, nb_xy, nb_oct, nb_ang, nb_valid,
                            cur_desc, cur_xy, cur_oct, cur_ang, cur_valid,
                            R_nb, t_nb, R_cur, t_cur, K, mcfg, scale_factor: float):
    """``CreateNewMapPoints``' device work for all B covisible neighbours
    at once: epipolar-gated matching (one ``hamming_matrix`` launch over the
    neighbours' stacked rows), DLT triangulation, and the cheirality /
    per-octave reprojection chi2 / parallax vetting.

    -> per neighbour [B, N1]: matches into the current keyframe's
    keypoints, world points [B, N1, 3], and the vetting mask."""
    F21 = fundamental_from_poses(R_nb, t_nb, R_cur, t_cur, K)
    m12 = search_for_triangulation(nb_desc, nb_xy, nb_oct, nb_ang, nb_valid,
                                   cur_desc, cur_xy, cur_oct, cur_ang, cur_valid,
                                   F21, mcfg, scale_factor).matches12
    has = m12 >= 0
    i2 = m12.clamp_min(0).long()
    x2 = cur_xy[i2]
    R_cur_b, t_cur_b = R_cur.expand_as(R_nb), t_cur.expand_as(t_nb)
    pts = triangulate_world(R_nb, t_nb, R_cur_b, t_cur_b, K, nb_xy, x2)

    def chi2(R, t, uv):
        pc = pts @ R.transpose(-1, -2) + t[:, None, :]
        z = pc[..., 2]
        zi = torch.where(z.abs() < 1e-9, 1e-9, z)
        u = K[0, 0] * pc[..., 0] / zi + K[0, 2]
        v = K[1, 1] * pc[..., 1] / zi + K[1, 2]
        return (u - uv[..., 0]) ** 2 + (v - uv[..., 1]) ** 2, z

    err1, z1 = chi2(R_nb, t_nb, nb_xy)
    err2, z2 = chi2(R_cur_b, t_cur_b, x2)
    s2_1 = scale_factor ** (2.0 * nb_oct.to(torch.float32))
    s2_2 = scale_factor ** (2.0 * cur_oct[i2].to(torch.float32))
    o1 = -(R_nb.transpose(-1, -2) @ t_nb[..., None])[..., 0]
    o2 = -(R_cur.T @ t_cur)
    r1 = pts - o1[:, None, :]
    r2 = pts - o2
    cosp = (r1 * r2).sum(-1) / (torch.linalg.vector_norm(r1, dim=-1)
                                * torch.linalg.vector_norm(r2, dim=-1)).clamp_min(1e-12)
    ok = (has & torch.isfinite(pts).all(-1) & (z1 > 0.05) & (z2 > 0.05)
          & (err1 < 5.991 * s2_1) & (err2 < 5.991 * s2_2) & (cosp < 0.9998))
    return m12, pts, ok


@dataclasses.dataclass
class _FrameSnap:
    """A frame kept as the initialization reference."""

    kps: Keypoints
    xy_un: torch.Tensor
    frame_id: int
    timestamp: float = 0.0


class Tracker:
    """Host-orchestrated monocular tracker over the port's device stages.

    ``track(image [H, W], timestamp) -> dict`` of per-frame metrics (the
    JAX tracker's keys). Runs on the card unless ``device="cpu"``."""

    def __init__(self, cfg: SystemConfig, device: torch.device | str = DEFAULT_DEVICE):
        tcfg = cfg.tracker
        if tcfg.use_bow:
            raise NotImplementedError(
                "use_bow=True: BoW place recognition (the vocabulary, BoW "
                "reference-keyframe matching and BoW relocalization) comes with a "
                "later slice of the port; pass use_bow=False")
        if tcfg.use_loop_closing:
            raise NotImplementedError(
                "use_loop_closing=True: loop closing comes with a later slice of "
                "the port; pass use_loop_closing=False")
        if tcfg.ba_segment_mode not in ("auto", "scatter"):
            raise ValueError(
                f"ba_segment_mode {tcfg.ba_segment_mode!r}: the port has the scatter "
                "formulation only ('auto' or 'scatter')")
        self.device = resolve_device(device)
        full_f32(self.device)
        self.cfg = cfg
        self.K = camera.intrinsics_matrix(cfg.camera, self.device)
        self.K_np = self.K.cpu().numpy()
        kp_cap = max(cfg.orb.max_keypoints, cfg.init_orb.max_keypoints)
        self.map = empty_map(tcfg, kp_cap, self.device)
        # the fused step, normal and with a 2x stage-1 window (low-match retry)
        self._fused = TrackingStep(cfg.camera, cfg.orb, cfg.matcher, tcfg,
                                   device=self.device)
        self._fused_wide = TrackingStep(cfg.camera, cfg.orb, cfg.matcher, tcfg,
                                        radius_scale=2.0, device=self.device)
        self._init_consts = ExtractorConstants(cfg.camera.height, cfg.camera.width,
                                               cfg.init_orb, self.device)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self.state = TrackState.NO_IMAGES_YET
        self.frame_id = -1
        self.ref: Optional[_FrameSnap] = None
        self.R = np.eye(3, dtype=np.float32)        # world-to-camera
        self.t = np.zeros(3, dtype=np.float32)
        self.vel_R = np.eye(3, dtype=np.float32)    # T_cur o T_prev^-1
        self.vel_t = np.zeros(3, dtype=np.float32)
        self.have_velocity = False
        self.frames_since_kf = 0
        self.n_kf = 0
        self.kf_insert_count = 0
        self.last_kf_slot = -1
        self.kf_ref_inliers = 0
        self.trajectory: list = []                  # (frame_id, ts, R, t)

    # ------------------------------------------------------------------
    def _uniforms(self, *shapes):
        """Uniform [0, 1) tensors of the given shapes, drawn in order from the
        tracker's generator: every random draw of the tracker comes from
        here (a test hands the JAX tracker's draws in through it)."""
        return tuple(torch.rand(s, generator=self.generator, device=self.device)
                     for s in shapes)

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), device=self.device)

    def track(self, image, timestamp: float) -> dict:
        """Process one grayscale frame; returns the per-frame metrics."""
        self.frame_id += 1
        cfg = self.cfg
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        metrics = {"frame_id": self.frame_id, "state": TrackState.NAMES[self.state]}
        if self.state == TrackState.WORKING:
            metrics.update(self._track_working(img))
        else:
            init_phase = self.state in (TrackState.NO_IMAGES_YET,
                                        TrackState.NOT_INITIALIZED,
                                        TrackState.INITIALIZING)
            if init_phase:
                kps = orb_extract(img, cfg.init_orb, self._init_consts)
            else:
                kps = orb_extract(img, cfg.orb, self._fused.consts)
            xy_un = camera.undistort_pixels(cfg.camera, kps.xy)
            n_kps = int(kps.count())
            metrics["n_kps"] = n_kps
            if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
                self._deal_first_frame(kps, xy_un, n_kps, timestamp)
            elif self.state == TrackState.INITIALIZING:
                metrics.update(self._try_initialize(kps, xy_un, n_kps, timestamp))
            elif self.state == TrackState.LOST:
                metrics.update(self._track_lost(kps, xy_un))
        metrics["state_after"] = TrackState.NAMES[self.state]
        if self.state == TrackState.WORKING:
            self.trajectory.append((self.frame_id, timestamp, self.R.copy(), self.t.copy()))
        return metrics

    # ------------------------------------------------------------------
    def _deal_first_frame(self, kps, xy_un, n_kps, timestamp):
        """``Tracking::DealFirstFrame``: >= 100 keypoints, snapshot the
        frame, INITIALIZING."""
        if n_kps < 100:
            self.state = TrackState.NOT_INITIALIZED
            return
        self.ref = _FrameSnap(kps=kps, xy_un=xy_un, frame_id=self.frame_id,
                              timestamp=timestamp)
        self.state = TrackState.INITIALIZING

    def _try_initialize(self, kps, xy_un, n_kps, timestamp) -> dict:
        """``Tracking::Initialize`` completed with map creation."""
        cfg = self.cfg
        if n_kps < 100:
            self.state = TrackState.NOT_INITIALIZED
            self.ref = None
            return {"init": "too few keypoints"}
        ref = self.ref
        res = search_for_initialization(
            ref.kps.desc, ref.xy_un, ref.kps.octave, ref.kps.angle_deg, ref.kps.valid,
            kps.desc, xy_un, kps.octave, kps.angle_deg, kps.valid, cfg.matcher)
        nm = int(res.n_matches)
        if nm < cfg.init.min_matches:
            # re-seed from this frame (tracking.cpp:63-70)
            self.ref = _FrameSnap(kps=kps, xy_un=xy_un, frame_id=self.frame_id,
                                  timestamp=timestamp)
            return {"init": f"too few matches ({nm})", "n_matches": nm}
        pairs, pv = compact_matches(res.matches12, cfg.matcher.max_matches)
        shape = (cfg.init.ransac_iterations, 8)
        u_h, u_f = self._uniforms(shape, shape)
        tv = initialize_two_view(ref.xy_un[pairs[:, 0].long()], xy_un[pairs[:, 1].long()],
                                 pv, self.K, u_h, u_f, cfg.init)
        out = {
            "n_matches": nm,
            "score_h": float(tv.score_h), "score_f": float(tv.score_f),
            "used_h": bool(tv.used_homography), "n_good": int(tv.n_good),
            "parallax_deg": float(tv.parallax_deg),
        }
        if not bool(tv.success):
            # keep the reference: later frames have a larger baseline to it
            out["init"] = "reconstruction failed"
            return out
        self._create_initial_map(kps, xy_un, pairs, tv)
        out["init"] = "success"
        out["n_map_points"] = int(self.map.n_points())
        return out

    def _create_initial_map(self, kps, xy_un, pairs, tv):
        """The two first keyframes and their points, scaled so the median
        depth in the first camera is 1, then a BA over both."""
        tri = tv.tri_mask.cpu().numpy()
        pts = tv.points3d.cpu().numpy()[tri]
        med = float(np.median(pts[:, 2]))
        pts = pts / med
        R21 = tv.R21.cpu().numpy()
        t21 = (tv.t21.cpu().numpy() / med).astype(np.float32)
        p = pairs.cpu().numpy()[tri]          # [G, 2] (ref kp, cur kp)
        G = pts.shape[0]
        oct2 = kps.octave.cpu().numpy()[p[:, 1]]
        inv_s2 = (1.0 / self.cfg.orb.scale_factor ** (2 * oct2)).astype(np.float32)

        m = self.map
        slots = self._t(np.arange(G))
        ok = torch.ones(G, dtype=torch.bool, device=self.device)
        p0, p1 = self._t(p[:, 0]).long(), self._t(p[:, 1]).long()
        zero = torch.zeros(G, dtype=torch.int32, device=self.device)
        one = zero + 1
        m = m._replace(
            pts=_set(m.pts, slots, self._t(pts), ok),
            desc=_set(m.desc, slots, kps.desc[p1], ok),
            pt_valid=_set(m.pt_valid, slots, True, ok),
            n_obs=_set(m.n_obs, slots, 2 * one, ok),
            pt_birth_kf=_set(m.pt_birth_kf, slots, zero, ok),
            pt_visible=_set(m.pt_visible, slots, one, ok),
            pt_found=_set(m.pt_found, slots, one, ok),
        )
        o0, o1 = slots, slots + G

        def two(x, v0, v1):
            return _set(_set(x, o0, v0, ok), o1, v1, ok)

        m = m._replace(
            obs_kf=two(m.obs_kf, zero, one), obs_pt=two(m.obs_pt, slots, slots),
            obs_kp=two(m.obs_kp, p0, p1),
            obs_uv=two(m.obs_uv, self.ref.xy_un[p0], xy_un[p1]),
            obs_inv_sigma2=two(m.obs_inv_sigma2, one.float(), self._t(inv_s2)),
            obs_valid=two(m.obs_valid, True, True),
        )
        kp_pt0 = np.full(self.ref.kps.valid.shape[0], -1, np.int32)
        kp_pt0[p[:, 0]] = np.arange(G)
        kp_pt1 = np.full(kps.valid.shape[0], -1, np.int32)
        kp_pt1[p[:, 1]] = np.arange(G)
        m = self._write_kf_snapshot(m, 0, self.ref.kps, self.ref.xy_un, kp_pt0,
                                    np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                                    self.ref.frame_id)
        m = self._write_kf_snapshot(m, 1, kps, xy_un, kp_pt1, R21, t21, self.frame_id)
        self.map = m
        self.n_kf = 2
        self.kf_insert_count = 2
        self.last_kf_slot = 1
        self.R, self.t = R21, t21
        self.have_velocity = False
        self.frames_since_kf = 0
        self.kf_ref_inliers = G
        # the reference keyframe's pose, stamped with its own capture time
        self.trajectory.append((self.ref.frame_id, self.ref.timestamp,
                                np.eye(3, dtype=np.float32), np.zeros(3, dtype=np.float32)))
        self._local_ba(1)
        self._refresh_viewing_stats()
        self.state = TrackState.WORKING

    # ------------------------------------------------------------------
    def _track_working(self, img) -> dict:
        """The fused step under the constant-velocity prediction, the
        low-match retry, the tallies and the keyframe decision."""
        cfg = self.cfg
        if cfg.tracker.use_motion_model and self.have_velocity:
            R_pred = self.vel_R @ self.R
            t_pred = self.vel_R @ self.t + self.vel_t
        else:
            R_pred, t_pred = self.R, self.t
        out = {}
        m = self.map
        args = (m.pts, m.desc, m.pt_valid, m.pt_normal, m.pt_dmin, m.pt_dmax,
                self._t(R_pred), self._t(t_pred), self._t(self.R), self._t(self.t), self.K)
        r = self._fused(img, *args)
        if int(r.n_matches1) < 20:
            r = self._fused_wide(img, *args)
        kps, xy_un = r.kps, r.xy_un
        n_matches1 = int(r.n_matches1)
        out["n_kps"] = int(r.n_kps)
        out["n_proj_matches"] = n_matches1
        out["n_proj_matches_2"] = int(r.n_matches2)
        if n_matches1 < cfg.tracker.min_tracked_inliers:
            if self._track_reference_keyframe(kps, xy_un, out):
                return out
            self.state = TrackState.LOST
            out["lost"] = "too few projection matches"
            return out

        n_inl = int(r.n_inliers)
        out["n_inliers"] = n_inl
        # MapPoint mnVisible / mnFound tallies
        found = (r.kp_for_point >= 0) & m.pt_valid
        self.map = m._replace(
            pt_visible=m.pt_visible + (r.visible & m.pt_valid).to(torch.int32),
            pt_found=m.pt_found + found.to(torch.int32))
        if n_inl < cfg.tracker.min_tracked_inliers:
            if self._track_reference_keyframe(kps, xy_un, out):
                return out
            self.state = TrackState.LOST
            out["lost"] = "too few pose inliers"
            return out

        R_new, t_new = r.R.cpu().numpy(), r.t.cpu().numpy()
        self.vel_R = R_new @ self.R.T
        self.vel_t = t_new - self.vel_R @ self.t
        self.have_velocity = True
        self.R, self.t = R_new, t_new
        self.frames_since_kf += 1
        if self._need_keyframe(n_inl):
            out.update(self._insert_keyframe(kps, xy_un, r))
        return out

    def _track_reference_keyframe(self, kps, xy_un, out: dict) -> bool:
        """``Tracking::TrackReferenceKeyFrame`` without a vocabulary: the
        frame's descriptors matched to the newest keyframe's point-associated
        keypoints (ratio 0.7), then pose LM from the last pose. On success
        the tracker is updated in place and True is returned."""
        if self.last_kf_slot < 0 or self.n_kf == 0:
            return False
        cfg = self.cfg
        m = self.map
        slot = self.last_kf_slot
        kf_pt = m.kf_kp_pt[slot].cpu().numpy()
        pt_valid = m.pt_valid.cpu().numpy()
        v_ref = (m.kf_kp_valid[slot].cpu().numpy() & (kf_pt >= 0)
                 & pt_valid[np.clip(kf_pt, 0, m.point_capacity - 1)])
        if int(v_ref.sum()) < 15:
            return False
        mnp = match_descriptors(m.kf_kp_desc[slot], self._t(v_ref), kps.desc, kps.valid,
                                ratio=0.7).cpu().numpy()
        sel = np.where(mnp >= 0)[0]
        if len(sel) < 15:
            return False
        # pose LM over the matched 2D-3D pairs, at the point capacity
        M = m.point_capacity
        n = len(sel)
        pts_m = np.zeros((M, 3), np.float32)
        uv_m = np.zeros((M, 2), np.float32)
        w_m = np.ones(M, np.float32)
        valid_m = np.zeros(M, bool)
        pts_m[:n] = m.pts.cpu().numpy()[kf_pt[sel]]
        uv_m[:n] = xy_un.cpu().numpy()[mnp[sel]]
        oct_np = kps.octave.cpu().numpy()[mnp[sel]].astype(np.float32)
        w_m[:n] = 1.0 / cfg.orb.scale_factor ** (2.0 * oct_np)
        valid_m[:n] = True
        res = optimize_pose(self._t(self.R), self._t(self.t), self._t(pts_m),
                            self._t(uv_m), self._t(w_m), self._t(valid_m), self.K)
        n_inl = int(res.n_inliers)
        if n_inl < max(10, cfg.tracker.min_tracked_inliers // 2):
            return False
        out["ref_kf_track"] = {"kf": slot, "n_bow": n, "n_inliers": n_inl}
        out["n_inliers"] = n_inl
        R_new, t_new = res.R.cpu().numpy(), res.t.cpu().numpy()
        self.vel_R = R_new @ self.R.T
        self.vel_t = t_new - self.vel_R @ self.t
        self.have_velocity = True
        self.R, self.t = R_new, t_new
        self.frames_since_kf += 1
        return True

    def _need_keyframe(self, n_inliers: int) -> bool:
        """A keyframe when tracking falls below 90 % of the reference
        keyframe's support, below 5x the inlier minimum, or after
        ``max_frames`` (``Config/Settings.hpp:44-46``)."""
        tcfg = self.cfg.tracker
        if self.frames_since_kf < tcfg.min_frames + 1:
            return False
        return (self.frames_since_kf >= tcfg.max_frames
                or n_inliers < 0.9 * self.kf_ref_inliers
                or n_inliers < tcfg.min_tracked_inliers * 5)

    def _write_kf_snapshot(self, m: SlamMap, slot: int, kps, xy_un, kp_pt, R, t,
                           frame_id: int) -> SlamMap:
        n = kps.valid.shape[0]
        if n > m.kp_capacity:
            raise ValueError(f"keypoint capacity {n} exceeds snapshot {m.kp_capacity}")
        return write_kf(m, slot, kps.desc, kps.octave, kps.angle_deg, kps.valid, xy_un,
                        self._t(np.asarray(kp_pt, np.int32)), self._t(R), self._t(t),
                        frame_id)

    def _insert_keyframe(self, kps, xy_un, assoc) -> dict:
        """Insert the current frame as a keyframe, then the tracking-side
        slice of local mapping: covisibility triangulation and fusion, point
        and keyframe culling, local BA, viewing statistics. ``assoc``: the
        fused step's result (final association and inlier mask)."""
        cfg = self.cfg
        slot = self._alloc_kf_slot()
        m = self.map
        kp_idx = assoc.kp_for_point.cpu().numpy()
        inl = assoc.inlier.cpu().numpy()
        tracked_pts = np.where(inl & (kp_idx >= 0))[0]
        oct_np = kps.octave.cpu().numpy()
        kp_pt = np.full(kps.valid.shape[0], -1, np.int32)
        kp_pt[kp_idx[tracked_pts]] = tracked_pts
        m = self._write_kf_snapshot(m, slot, kps, xy_un, kp_pt, self.R, self.t, self.frame_id)
        rows = free_slots(m.obs_valid, len(tracked_pts))
        n_add = len(rows)
        if n_add > 0:
            sel = tracked_pts[:n_add]
            kp_sel = kp_idx[sel]
            inv_s2 = (1.0 / cfg.orb.scale_factor ** (2 * oct_np[kp_sel])).astype(np.float32)
            m = scatter_obs(m, slot, self._t(rows), self._t(sel), self._t(kp_sel),
                            xy_un[self._t(kp_sel).long()], self._t(inv_s2),
                            torch.ones(n_add, dtype=torch.bool, device=self.device), 0)
        self.map = m
        self.kf_insert_count += 1
        self.last_kf_slot = slot
        out = {"kf": f"inserted slot {slot}", "kf_obs": int(n_add)}
        new_n, fused_n = self._create_new_points_covis(slot)
        out["kf_new_points"] = new_n
        out["kf_fused"] = fused_n
        out["culled_points"] = self._cull_points()
        out["culled_kfs"] = self._cull_keyframes()
        out.update(self._local_ba(slot))
        self._refresh_viewing_stats()
        self.n_kf = int(self.map.kf_valid.sum())
        self.frames_since_kf = 0
        self.kf_ref_inliers = int(n_add) + new_n
        return out

    def _refresh_viewing_stats(self):
        ocfg = self.cfg.orb
        self.map = update_normal_and_depth(self.map, ocfg.scale_factor, ocfg.n_levels)

    # -------------------- local-mapping slice --------------------
    def _alloc_kf_slot(self) -> int:
        """The first free keyframe slot; at capacity, evict the most
        redundant unprotected keyframe, ties toward the oldest."""
        m = self.map
        free = np.where(~m.kf_valid.cpu().numpy())[0]
        if len(free):
            return int(free[0])
        scores = self._kf_redundancy()
        fids = m.kf_frame_id.cpu().numpy()
        protect = self._protected_kfs()
        scores = np.where(np.isin(np.arange(m.kf_capacity), list(protect)), -np.inf, scores)
        best = int(np.lexsort((fids, -scores))[0])
        self._remove_keyframe(best)
        return best

    def _protected_kfs(self) -> set:
        """Never culled or evicted: the oldest keyframe (the gauge anchor)
        and the two most recent."""
        m = self.map
        kf_valid = m.kf_valid.cpu().numpy()
        fids = m.kf_frame_id.cpu().numpy()
        vs = np.where(kf_valid)[0]
        if len(vs) == 0:
            return set()
        prot = set(vs[np.argsort(-fids[vs])][:2].tolist())
        prot.add(int(vs[np.argmin(fids[vs])]))
        return prot

    def _kf_redundancy(self) -> np.ndarray:
        """Per keyframe, the fraction of its observed points seen by >= 4
        keyframes (KeyFrameCulling's measure)."""
        m = self.map
        obs_valid = m.obs_valid.cpu().numpy()
        obs_kf = m.obs_kf.cpu().numpy()
        n_obs = m.n_obs.cpu().numpy()
        red = np.asarray(obs_valid & (n_obs[m.obs_pt.cpu().numpy()] >= 4), np.float64)
        tot = np.bincount(obs_kf, weights=obs_valid, minlength=m.kf_capacity)
        hit = np.bincount(obs_kf, weights=red, minlength=m.kf_capacity)
        return hit / np.maximum(tot, 1.0)

    def _remove_keyframe(self, slot: int) -> None:
        self.map = remove_kf(self.map, slot)

    def _cull_points(self) -> int:
        """MapPointCulling: points short of ``cull_min_obs`` observations
        ``cull_age_kfs`` keyframes after creation, or whose found/visible
        ratio collapsed. Their slots are recycled."""
        cfg = self.cfg.tracker
        m = self.map
        valid = m.pt_valid.cpu().numpy()
        n_obs = m.n_obs.cpu().numpy()
        age = self.kf_insert_count - m.pt_birth_kf.cpu().numpy()
        vis = m.pt_visible.cpu().numpy()
        fnd = m.pt_found.cpu().numpy()
        bad = valid & (((age >= cfg.cull_age_kfs) & (n_obs < cfg.cull_min_obs))
                       | ((vis >= cfg.cull_min_visible) & (fnd < cfg.cull_found_ratio * vis)))
        n_bad = int(bad.sum())
        if n_bad == 0:
            return 0
        bad_t = self._t(bad)
        snap = m.kf_kp_pt
        snap_bad = bad_t[snap.clamp_min(0).long()] & (snap >= 0)
        self.map = m._replace(pt_valid=m.pt_valid & ~bad_t,
                              obs_valid=m.obs_valid & ~bad_t[m.obs_pt.long()],
                              kf_kp_pt=torch.where(snap_bad, -1, snap))
        return n_bad

    def _cull_keyframes(self) -> int:
        """KeyFrameCulling: remove the most redundant unprotected keyframe
        with >= 10 observations when >= ``kf_redundancy_frac`` of its points
        are seen by >= 4 keyframes; at most one per insert."""
        cfg = self.cfg.tracker
        m = self.map
        kf_valid = m.kf_valid.cpu().numpy()
        counts = np.bincount(m.obs_kf.cpu().numpy(), weights=m.obs_valid.cpu().numpy(),
                             minlength=m.kf_capacity)
        red = self._kf_redundancy()
        protect = self._protected_kfs()
        cand = [k for k in np.where(kf_valid)[0]
                if k not in protect and counts[k] >= 10 and red[k] >= cfg.kf_redundancy_frac]
        if not cand:
            return 0
        self._remove_keyframe(int(max(cand, key=lambda k: red[k])))
        return 1

    def _create_new_points_covis(self, slot: int):
        """CreateNewMapPoints: triangulate the current keyframe's
        unassociated keypoints against its best covisible keyframes, fusing
        candidates that duplicate an existing point's projection."""
        cfg = self.cfg
        tcfg = cfg.tracker
        m = self.map
        kf_kp_pt = m.kf_kp_pt.cpu().numpy()
        kf_valid = m.kf_valid.cpu().numpy()
        cur_assoc = kf_kp_pt[slot]
        pt_mask = np.zeros(m.point_capacity, bool)
        pt_mask[cur_assoc[cur_assoc >= 0]] = True
        shared = np.zeros(m.kf_capacity, np.int64)
        for k in np.where(kf_valid)[0]:
            if k == slot:
                continue
            assoc = kf_kp_pt[k]
            shared[k] = pt_mask[assoc[assoc >= 0]].sum()
        order = np.argsort(-shared)
        neighbors = [int(k) for k in order
                     if kf_valid[k] and k != slot and shared[k] >= tcfg.covis_min_shared
                     ][: tcfg.covis_keyframes]
        if not neighbors and shared.max() > 0:
            neighbors = [int(order[0])]
        if not neighbors:
            return 0, 0
        R_cur = m.kf_R[slot].cpu().numpy()
        t_cur = m.kf_t[slot].cpu().numpy()

        # the device work for every neighbour at once
        nbs = self._t(np.asarray(neighbors, np.int64))
        nb_free = torch.as_tensor(kf_kp_pt[neighbors] < 0, device=self.device)
        cur_free = torch.as_tensor(kf_kp_pt[slot] < 0, device=self.device)
        m12_b, pts_b, ok_b = covis_match_triangulate(
            m.kf_kp_desc[nbs], m.kf_kp_xy[nbs], m.kf_kp_octave[nbs], m.kf_kp_angle[nbs],
            m.kf_kp_valid[nbs] & nb_free,
            m.kf_kp_desc[slot], m.kf_kp_xy[slot], m.kf_kp_octave[slot], m.kf_kp_angle[slot],
            m.kf_kp_valid[slot] & cur_free,
            m.kf_R[nbs], m.kf_t[nbs], m.kf_R[slot], m.kf_t[slot], self.K,
            cfg.matcher, cfg.orb.scale_factor)
        m12_b = m12_b.cpu().numpy()
        pts_b = pts_b.cpu().numpy()
        ok_b = ok_b.cpu().numpy()
        nb_xy_np = m.kf_kp_xy[nbs].cpu().numpy()
        nb_oct_np = m.kf_kp_octave[nbs].cpu().numpy()
        cur_xy_np = m.kf_kp_xy[slot].cpu().numpy()
        cur_oct_np = m.kf_kp_octave[slot].cpu().numpy()
        kp_desc_cur = m.kf_kp_desc[slot].cpu().numpy()
        fuse_r2 = tcfg.fuse_radius_px ** 2

        # neighbours in order: a current keypoint taken by an earlier one's
        # creation or fusion is excluded for the later ones
        consumed = np.zeros(cur_xy_np.shape[0], bool)
        n_new_total = n_fused = 0
        for b, nb in enumerate(neighbors):
            m = self.map
            ok = ok_b[b] & ~consumed[np.clip(m12_b[b], 0, None)]
            i1 = np.where(ok)[0]
            if len(i1) == 0:
                continue
            i2 = m12_b[b][i1]
            # existing points projected into the current keyframe, refreshed
            # per neighbour so points made for an earlier one count
            pc = m.pts.cpu().numpy() @ R_cur.T + t_cur
            zs = np.where(np.abs(pc[:, 2:]) < 1e-9, 1e-9, pc[:, 2:])
            proj = (pc[:, :2] / zs) @ self.K_np[:2, :2].T + self.K_np[:2, 2]
            proj_ok = m.pt_valid.cpu().numpy() & (pc[:, 2] > 0.05)
            created, fused = self._insert_triangulated(
                slot, nb, i1, i2, pts_b[b][i1], nb_xy_np[b][i1], nb_oct_np[b][i1],
                cur_oct_np[i2], proj, proj_ok, m.desc.cpu().numpy(), kp_desc_cur,
                cur_xy_np[i2], fuse_r2)
            consumed[i2] = True
            n_new_total += created
            n_fused += fused
        return n_new_total, n_fused

    def _insert_triangulated(self, slot, nb, i1, i2, pts, uv1_all, oct1, oct2, proj,
                             proj_ok, map_desc_np, kp_desc_cur, x2, fuse_r2):
        """Insert vetted triangulations; a candidate whose keypoint lies
        within ``fuse_r2`` of an existing point's projection, at Hamming
        distance <= ``th_low``, becomes an observation of that point."""
        cfg = self.cfg
        m = self.map
        n_cand = len(i1)
        if n_cand == 0:
            return 0, 0
        fuse_target = np.full(n_cand, -1, np.int64)
        if proj_ok.any():
            pidx = np.where(proj_ok)[0]
            d2 = ((proj[pidx, 0][None, :] - x2[:, 0][:, None]) ** 2
                  + (proj[pidx, 1][None, :] - x2[:, 1][:, None]) ** 2)
            cc, pp = np.nonzero(d2 < fuse_r2)
            if len(cc):
                xor = torch.from_numpy(kp_desc_cur[i2[cc]] ^ map_desc_np[pidx[pp]])
                hd = popcount(xor).sum(dim=1).numpy()
                # per candidate the least distance: the first of its block
                order = np.lexsort((hd, cc))
                first = np.ones(len(order), bool)
                first[1:] = cc[order][1:] != cc[order][:-1]
                win = order[first]
                ok_w = hd[win] <= cfg.matcher.th_low
                fuse_target[cc[win][ok_w]] = pidx[pp[win][ok_w]]
        fused_idx = np.where(fuse_target >= 0)[0]
        new_idx = np.where(fuse_target < 0)[0]
        obs_valid_np = m.obs_valid.cpu().numpy().copy()
        s = cfg.orb.scale_factor

        n_fused = 0
        if len(fused_idx):
            rows = free_slots(obs_valid_np, len(fused_idx))
            take = fused_idx[: len(rows)]
            n_fused = len(take)
            inv_s2 = (1.0 / s ** (2 * oct2[take])).astype(np.float32)
            m = scatter_obs(m, slot, self._t(rows), self._t(fuse_target[take]),
                            self._t(i2[take]), self._t(x2[take].astype(np.float32)),
                            self._t(inv_s2),
                            torch.ones(n_fused, dtype=torch.bool, device=self.device), 1)
            obs_valid_np[rows] = True

        free_pts = free_slots(m.pt_valid, len(new_idx))
        rows = free_slots(obs_valid_np, 2 * len(free_pts))
        n_new = min(len(free_pts), len(rows) // 2)
        if n_new > 0:
            take = new_idx[:n_new]
            inv1 = (1.0 / s ** (2 * oct1[take])).astype(np.float32)
            inv2 = (1.0 / s ** (2 * oct2[take])).astype(np.float32)
            m = scatter_new_points(
                m, slot, nb, self._t(free_pts[:n_new]), self._t(rows[:n_new]),
                self._t(rows[n_new: 2 * n_new]), self._t(i1[take]), self._t(i2[take]),
                self._t(pts[take].astype(np.float32)),
                self._t(uv1_all[take].astype(np.float32)),
                self._t(x2[take].astype(np.float32)), self._t(inv1), self._t(inv2),
                torch.full((n_new,), self.kf_insert_count, dtype=torch.int32,
                           device=self.device),
                torch.ones(n_new, dtype=torch.bool, device=self.device))
        self.map = m
        return int(n_new), int(n_fused)

    def _local_ba(self, newest_slot: int) -> dict:
        """Local BA: the ``ba_window`` most recent keyframes (by frame id)
        free, the older ones and the oldest of all fixed (the gauge); every
        map point free. The newest keyframe's refined pose becomes the
        current pose."""
        cfg = self.cfg
        m = self.map
        window = cfg.tracker.ba_window
        kf_valid = m.kf_valid.cpu().numpy()
        fids = m.kf_frame_id.cpu().numpy()
        fixed = ~kf_valid
        vs = np.where(kf_valid)[0]
        if len(vs):
            recent = set(vs[np.argsort(-fids[vs])][:window].tolist())
            for k in vs:
                if int(k) not in recent:
                    fixed[k] = True
            fixed[vs[np.argmin(fids[vs])]] = True
        res = bundle_adjust(
            m.kf_R, m.kf_t, m.pts, m.obs_kf, m.obs_pt, m.obs_uv, m.obs_inv_sigma2,
            m.obs_valid, self._t(fixed), m.pt_valid, self.K,
            iterations=cfg.tracker.ba_iterations, max_free_cams=window,
            early_stop_rel=cfg.tracker.ba_early_stop_rel)
        self.map = apply_ba_result(m, res)
        self.R = res.kf_R[newest_slot].cpu().numpy()
        self.t = res.kf_t[newest_slot].cpu().numpy()
        self.have_velocity = False  # the velocity is stale after the jump
        return {"ba_cost0": float(res.cost0), "ba_cost": float(res.cost),
                "ba_inlier_obs": int(res.obs_inlier.sum())}

    # ------------------------------------------------------------------
    def _track_lost(self, kps, xy_un) -> dict:
        """Map-wide relocalization: every valid map point finds its best
        frame keypoint (no spatial window, loose gates), RANSAC PnP on the
        2D-3D matches, pose LM on its inliers, a tight re-match from that
        pose and a final LM."""
        cfg = self.cfg
        mp = self.map
        reloc_kf = -1
        mnp = match_descriptors(mp.desc, mp.pt_valid, kps.desc, kps.valid,
                                ratio=0.9, th=cfg.matcher.th_high).cpu().numpy()
        pt_sel = np.where(mnp >= 0)[0]
        if len(pt_sel) < 12:
            return {"reloc": "too few 2d-3d matches", "reloc_kf": reloc_kf,
                    "n_2d3d": len(pt_sel)}
        kp_sel = mnp[pt_sel]
        M = mp.point_capacity
        n = len(kp_sel)
        pts_m = np.zeros((M, 3), np.float32)
        uv_m = np.zeros((M, 2), np.float32)
        valid_m = np.zeros(M, bool)
        pts_m[:n] = mp.pts.cpu().numpy()[pt_sel]
        uv_m[:n] = xy_un.cpu().numpy()[kp_sel]
        valid_m[:n] = True
        pts_t, uv_t = self._t(pts_m), self._t(uv_m)
        (u,) = self._uniforms((RELOC_HYPOTHESES, 6))
        pnp = ransac_pnp(pts_t, uv_t, self._t(valid_m), self.K, u)
        pnp_inl = int(pnp.n_inliers)
        if not bool(pnp.ok) or pnp_inl < 10:
            return {"reloc": "pnp failed", "reloc_kf": reloc_kf, "n_2d3d": n,
                    "pnp_inl": pnp_inl}
        res = optimize_pose(pnp.R, pnp.t, pts_t, uv_t,
                            torch.ones(M, device=self.device), pnp.inliers, self.K)
        pm = search_by_projection(
            mp.pts, mp.desc, mp.pt_valid, res.R, res.t, self.K,
            kps.desc, xy_un, kps.valid, cfg.tracker.projection_radius, cfg.matcher,
            cfg.camera.width, cfg.camera.height, kp_octave=kps.octave,
            scale_factor=cfg.orb.scale_factor, pt_normal=mp.pt_normal,
            pt_dmin=mp.pt_dmin, pt_dmax=mp.pt_dmax, n_levels=cfg.orb.n_levels)
        safe = pm.kp_for_point.clamp_min(0).long()
        inv_s2 = 1.0 / cfg.orb.scale_factor ** (2.0 * kps.octave[safe].to(torch.float32))
        res = optimize_pose(res.R, res.t, mp.pts, xy_un[safe], inv_s2,
                            pm.kp_for_point >= 0, self.K)
        n_inl = int(res.n_inliers)
        if n_inl < cfg.tracker.min_tracked_inliers * 2:
            return {"reloc": "pose failed", "reloc_kf": reloc_kf, "n_2d3d": n,
                    "pnp_inl": pnp_inl}
        self.R = res.R.cpu().numpy()
        self.t = res.t.cpu().numpy()
        self.have_velocity = False
        self.frames_since_kf = 0
        self.state = TrackState.WORKING
        return {"reloc": "recovered", "reloc_kf": reloc_kf, "n_inliers": n_inl}
