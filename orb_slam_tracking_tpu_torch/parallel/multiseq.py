"""Multi-sequence data parallelism (counterpart of ``parallel/multiseq.py``).

Many sequences tracked at once: the per-frame work (extraction,
projection matching, the pose LM) is the same for every sequence, so B
sequences ride a leading batch axis of one program. The JAX module
``vmap``s the single-sequence step and shards the batch over a mesh's
``dp`` axis; here the runners take a ``device`` (the card unless
``device="cpu"``) and any B. The batch axis is written out: every
per-sequence tensor carries a leading [B] (``K`` is shared), and each
frame of B sequences launches the extraction's FAST and
orient-and-describe kernels once and the fused Hamming kernel once per
match, whatever B is.

Every runner also spreads B over the ranks of a process group (``group``,
the JAX mesh's ``dp`` axis across devices): every rank is given the
whole batch, runs its contiguous B/D sequences through the [B] path on
its own device (one sequence a rank is a batch of one), and the outputs
are all-gathered in sequence order, so every rank returns the whole
batch's. No collective runs inside a run's frame loop: the init and
mapping runners' host reads a frame cover the rank's own rows only, and
the final gather is the one collective. ``group=None`` keeps the batch
on this process's device.

Four runners, as the JAX module's:

* ``make_multiseq_step``: one frame of B sequences against frozen maps;
* ``make_multiseq_sequence_runner``: T frames of B sequences with the
  constant-velocity carry and frozen maps, with no host read inside the
  run (the JAX ``scan`` over frames);
* ``make_multiseq_init_runner``: the NOT_INITIALIZED -> INITIALIZING ->
  WORKING machine per sequence with median-depth map seeding. Under
  ``vmap`` the JAX runner pays every branch on every frame as selects;
  here host reads of the keypoint and match counts a frame split the
  batch, and each branch runs batched on its sequences only;
* ``make_multiseq_mapping_runner``: the device-side mapping loop
  (``slam/device_mapping.py``'s ``DeviceSequenceLoop``, whose one frame
  loop takes the leading [B]) over B sequences with growing maps: the
  tracking step batched, one host read a frame of the [B] "held / keyframe
  due" flags, and the recovery tier and the keyframe insert only for the
  sequences that need them, on their rows of the batched map.

Every LM step takes the closed-form 6x6 solve (``batched_solve=True``), as
every JAX runner does.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed

from ..config import CameraConfig, InitConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..device import DEFAULT_DEVICE, full_f32, resolve_device
from ..geometry.camera import undistort_pixels
from ..geometry.twoview import initialize_two_view
from ..ops.extractor import ExtractorConstants, orb_extract
from ..ops.matcher import compact_matches, search_for_initialization
from ..ops.proj_matcher import search_by_projection
from ..optim.pose_opt import optimize_pose
from ..slam.device_mapping import DeviceSequenceLoop, _index_batch, _matvec
from ..slam.fused_step import TrackingStep
from ..slam.map import SlamMap
from ..utils import profiling
from .distributed import all_gather, group_rank_size

__all__ = ["MultiseqResult", "make_multiseq_step", "make_multiseq_sequence_runner",
           "make_multiseq_init_runner", "make_multiseq_mapping_runner",
           "MultiseqInitRunner"]


class MultiseqResult(NamedTuple):
    R: torch.Tensor          # [B, 3, 3] optimised world-to-camera poses
    t: torch.Tensor          # [B, 3]
    n_inliers: torch.Tensor  # [B]
    n_matches: torch.Tensor  # [B]
    n_kps: torch.Tensor      # [B]


def _no_stats(map_pts: torch.Tensor):
    """Zero viewing statistics (normal, dmin, dmax): ``dmax == 0`` turns the
    frustum gates and the predicted-octave window off point by point, as
    the JAX runners' frozen maps (``multiseq.py:135-137``)."""
    zn = torch.zeros_like(map_pts)
    zd = torch.zeros(map_pts.shape[:-1], dtype=map_pts.dtype, device=map_pts.device)
    return zn, zd, zd


def _rows(x, lo: int, hi: int):
    """Rows ``lo:hi`` of the leading [B] of a tensor, of every field of a
    NamedTuple (a ``SlamMap``), or of a list of host values."""
    if isinstance(x, torch.Tensor):
        return x[lo:hi]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_rows(v, lo, hi) for v in x))
    return list(x)[lo:hi]


def _gathered(x, group, size: int):
    """Every rank's rows of ``x`` (a tensor, or a dict, tuple or NamedTuple
    of them, one shape on every rank) concatenated in rank order along
    the leading axis."""
    if isinstance(x, torch.Tensor):
        return all_gather(x, group, size).reshape((size * x.shape[0],) + x.shape[1:])
    if isinstance(x, dict):
        return {k: _gathered(v, group, size) for k, v in x.items()}
    if hasattr(x, "_fields"):
        return type(x)(*(_gathered(v, group, size) for v in x))
    return type(x)(_gathered(v, group, size) for v in x)


def _dp(group, fn, shared=(-1,)):
    """``fn`` over this rank's contiguous rows of the leading [B] of every
    argument but those at the positions ``shared`` (``K``), its outputs
    all-gathered in sequence order; ``fn`` itself when ``group`` is None.
    A sharded argument is a tensor, a NamedTuple of tensors or a list of B
    host values; the first is the images. B must divide over the ranks:
    that is checked before any collective."""
    if group is None:
        return fn

    def sharded(*args):
        shared_at = {i % len(args) for i in shared}
        rank, size = group_rank_size(group, args[0].device)
        B = args[0].shape[0]
        if B % size:
            raise ValueError(f"{B} sequences do not divide over {size} ranks")
        per = B // size
        lo, hi = rank * per, (rank + 1) * per
        out = fn(*(a if i in shared_at else _rows(a, lo, hi) for i, a in enumerate(args)))
        return _gathered(out, group, size)

    return sharded


def make_multiseq_step(orb_cfg: OrbConfig, matcher_cfg: MatcherConfig, width: int,
                       height: int, radius: float = 15.0,
                       device: torch.device | str = DEFAULT_DEVICE,
                       group: Optional[torch.distributed.ProcessGroup] = None):
    """The one-frame DP step (``multiseq.py:51-103``):

    ``step(images [B,H,W], map_pts [B,P,3], map_desc [B,P,8] int32,
    map_valid [B,P], R [B,3,3], t [B,3], K [3,3]) -> MultiseqResult``.

    Extraction, one projection match at ``radius`` on the raw keypoint
    pixels and the pose LM (default rounds), batched; with a ``group``,
    each rank's B/D sequences (see the module docstring)."""
    device = resolve_device(device)
    full_f32(device)
    consts = ExtractorConstants(height, width, orb_cfg, device)
    scale = orb_cfg.scale_factor

    @functools.partial(_dp, group)
    def step(images, map_pts, map_desc, map_valid, R, t, K) -> MultiseqResult:
        kps = orb_extract(images, orb_cfg, consts)
        zn, zd, _ = _no_stats(map_pts)
        pm = search_by_projection(
            map_pts, map_desc, map_valid, R, t, K, kps.desc, kps.xy, kps.valid, radius,
            matcher_cfg, width, height, kp_octave=kps.octave, scale_factor=scale,
            pt_normal=zn, pt_dmin=zd, pt_dmax=zd, n_levels=orb_cfg.n_levels)
        safe = pm.kp_for_point.clamp_min(0).long()
        uv_obs = torch.take_along_dim(kps.xy, safe[..., None], dim=-2)
        inv_s2 = 1.0 / scale ** (2.0 * kps.octave.gather(-1, safe).to(torch.float32))
        res = optimize_pose(R, t, map_pts, uv_obs, inv_s2, pm.kp_for_point >= 0, K,
                            batched_solve=True)
        return MultiseqResult(res.R, res.t, res.n_inliers, pm.n_matches, kps.count())

    return step


def make_multiseq_sequence_runner(cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                                  matcher_cfg: MatcherConfig, tracker_cfg: TrackerConfig,
                                  device: torch.device | str = DEFAULT_DEVICE,
                                  group: Optional[torch.distributed.ProcessGroup] = None):
    """Whole sequences with frozen maps (``multiseq.py:106-173``):

    ``run(images [B,T,H,W], map_pts [B,P,3], map_desc [B,P,8] int32,
    map_valid [B,P], R0 [B,3,3], t0 [B,3], K [3,3]) -> dict`` of
    trajectories ``R [B,T,3,3]``, ``t [B,T,3]``, ``n_inliers [B,T]``,
    ``n_matches [B,T]`` (the tight stage's).

    Frame by frame the fused two-stage step of every sequence, its stage-1
    window centred on the constant-velocity prediction from the second
    frame on (the JAX carry's ``have_vel``, known on the host here). Nothing
    in a run reads the device from the host; ``run.step`` is the batched
    ``TrackingStep``. With a ``group``, each rank runs its B/D sequences
    (see the module docstring). Spans (``utils/profiling``): ``runner.run``
    around the call, the root of its ``runner.frame`` spans, one a frame
    (the carry and the step, whose own spans nest in it)."""
    step = TrackingStep(cam_cfg, orb_cfg, matcher_cfg, tracker_cfg, batched_solve=True,
                        device=device)

    @functools.partial(_dp, group)
    def run(images, map_pts, map_desc, map_valid, R0, t0, K) -> Dict[str, torch.Tensor]:
        with profiling.span("runner.run"):
            zn, zd, _ = _no_stats(map_pts)
            R, t = R0, t0
            vel_R = vel_t = None
            outs = []
            for f in range(images.shape[1]):
                with profiling.span("runner.frame"):
                    if vel_R is None:
                        R_pred, t_pred = R, t
                    else:
                        R_pred, t_pred = vel_R @ R, _matvec(vel_R, t) + vel_t
                    r = step(images[:, f], map_pts, map_desc, map_valid, zn, zd, zd,
                             R_pred, t_pred, R, t, K)
                    vel_R = r.R @ R.transpose(-1, -2)
                    vel_t = r.t - _matvec(vel_R, t)
                    R, t = r.R, r.t
                    outs.append((r.R, r.t, r.n_inliers, r.n_matches2))
            Rs, ts, n_inl, n_m = (torch.stack(x, dim=1) for x in zip(*outs))
            return {"R": Rs, "t": ts, "n_inliers": n_inl, "n_matches": n_m}

    run.step = step
    return run


class MultiseqInitRunner:
    """Sequences that initialize themselves (``multiseq.py:176-370``).

    ``run(images [B,T,H,W], K [3,3], seeds: list of B ints) -> dict``:
    ``initialized [B]`` bool, ``init_frame [B]`` int32 (-1 if never),
    ``map_pts [B,Pc,3]``, ``map_desc [B,Pc,8]``, ``map_valid [B,Pc]``,
    ``R [B,T,3,3]``, ``t [B,T,3]`` (identity until initialization; the
    world frame is the reference camera), ``state [B,T]`` int32 (0
    NOT_INITIALIZED, 1 INITIALIZING, 2 WORKING, after the frame),
    ``n_matches [B,T]`` int32 (the tight match when WORKING, else the
    initialization match): the JAX runner's dict, key for key.

    A frame extracts every sequence at once; a host read of its [B]
    keypoint counts and the states on the host split the batch, and each
    branch runs batched over its sequences: those in state 0 or 1 that
    have a reference are matched against it in one call (as under the JAX
    selects, whose outputs report that count; one read of the counts);
    the INITIALIZING ones with enough keypoints and matches take the
    two-view attempt together (``initialize_two_view`` under
    ``torch.func.vmap``; one read of the outcomes); the sequences WORKING
    at the frame's start take the two-stage track together, on their
    rows. The attempts' draws are
    indexed by (sequence, frame), as the JAX runner splits each
    sequence's key once a frame whatever its state: ``uniforms(b, f)`` ->
    ``(u_h, u_f)``, each ``[ransac_iterations, 8]``; by default a
    generator seeded with ``seeds[b] * 2**20 + f``. With a ``group``, a
    rank runs its rows of the batch and ``b`` stays the sequence's index in
    the whole batch."""

    def __init__(self, cam_cfg: CameraConfig, orb_cfg: OrbConfig, matcher_cfg: MatcherConfig,
                 tracker_cfg: TrackerConfig, init_cfg: InitConfig, point_capacity: int = 512,
                 device: torch.device | str = DEFAULT_DEVICE,
                 group: Optional[torch.distributed.ProcessGroup] = None):
        self.cam_cfg, self.orb_cfg, self.matcher_cfg = cam_cfg, orb_cfg, matcher_cfg
        self.tracker_cfg, self.init_cfg = tracker_cfg, init_cfg
        self.point_capacity = point_capacity
        self.device = resolve_device(device)
        self.step = TrackingStep(cam_cfg, orb_cfg, matcher_cfg, tracker_cfg,
                                 batched_solve=True, device=self.device)
        self.uniforms: Optional[Callable[[int, int], Tuple[torch.Tensor, torch.Tensor]]] = None
        # the two-view attempt over the attempting sequences' leading axis
        self._two_view = torch.func.vmap(
            lambda x1, x2, v, K, u_h, u_f: initialize_two_view(x1, x2, v, K, u_h, u_f, init_cfg),
            in_dims=(0, 0, 0, None, 0, 0))
        self._sharded = _dp(group, self._run, shared=(1,))

    def _draws(self, seeds, seqs, b: int, f: int):
        if self.uniforms is not None:
            return self.uniforms(seqs[b], f)
        g = torch.Generator(device=self.device).manual_seed(int(seeds[b]) * 2 ** 20 + f)
        shape = (self.init_cfg.ransac_iterations, 8)
        return tuple(torch.rand(shape, generator=g, device=self.device) for _ in range(2))

    def __call__(self, images: torch.Tensor, K: torch.Tensor, seeds) -> Dict[str, torch.Tensor]:
        return self._sharded(images, K, list(seeds), list(range(images.shape[0])))

    def _run(self, images: torch.Tensor, K: torch.Tensor, seeds, seqs) -> Dict[str, torch.Tensor]:
        """The runner on the rows given; ``seqs`` are their indices in the
        whole batch, by which the draws go."""
        B, T = images.shape[:2]
        Pc, icfg, tcfg = self.point_capacity, self.init_cfg, self.tracker_cfg
        dev = images.device
        eye = torch.eye(3, device=dev)
        state: List[int] = [0] * B
        ref: List[Optional[tuple]] = [None] * B
        mp = torch.zeros((B, Pc, 3), device=dev)
        md = torch.zeros((B, Pc, 8), dtype=torch.int32, device=dev)
        mv = torch.zeros((B, Pc), dtype=torch.bool, device=dev)
        R = eye.expand(B, 3, 3).clone()
        t = torch.zeros((B, 3), device=dev)
        vel_R, vel_t = R.clone(), t.clone()
        have_vel = [False] * B
        init_frame = [-1] * B
        zn, zd, _ = _no_stats(mp)
        Rs, ts, states, n_outs = [], [], [], []
        for f in range(T):
            kps = orb_extract(images[:, f], self.orb_cfg, self.step.consts)
            xy_un = undistort_pixels(self.cam_cfg, kps.xy)
            enough = (kps.count() >= 100).tolist()   # the frame's host read
            n_out = torch.zeros(B, dtype=torch.int32, device=dev)
            R_new, t_new = R.clone(), t.clone()
            new_state = list(state)
            cur = (kps.desc, xy_un, kps.octave, kps.angle_deg, kps.valid)
            # the matches against each reference, for the sequences that have one
            # and are not WORKING (as under JAX's selects, whose output reports them)
            rows = [b for b in range(B) if state[b] != 2 and ref[b] is not None]
            nm = {}
            if rows:
                idx = torch.tensor(rows, device=dev)
                res = search_for_initialization(
                    *(torch.stack([ref[b][k] for b in rows]) for k in range(5)),
                    *(x[idx] for x in cur), self.matcher_cfg)
                n_out[idx] = res.n_matches
                nm = dict(zip(rows, res.n_matches.tolist()))   # a host read
            attempt = []
            for b in range(B):
                if state[b] == 2:
                    continue
                if not enough[b]:
                    # too few keypoints: INITIALIZING drops back, and state 0 waits
                    new_state[b] = 0
                elif state[b] == 0 or nm[b] < icfg.min_matches:
                    # (re-)seed the reference from this frame (tracking.cpp:63-110)
                    ref[b], new_state[b] = tuple(x[b] for x in cur), 1
                else:
                    attempt.append(b)
            if attempt:
                # the two-view attempts of the sub-batch together
                a = torch.tensor([rows.index(b) for b in attempt], device=dev)
                pairs, pv = compact_matches(res.matches12[a], Pc)
                i1, i2 = (pairs[..., k].long()[..., None] for k in (0, 1))
                x1 = torch.take_along_dim(torch.stack([ref[b][1] for b in attempt]), i1, dim=1)
                aidx = torch.tensor(attempt, device=dev)
                x2 = torch.take_along_dim(xy_un[aidx], i2, dim=1)
                u_h, u_f = (torch.stack(u) for u in zip(*(self._draws(seeds, seqs, b, f)
                                                           for b in attempt)))
                tv = self._two_view(x1, x2, pv, K, u_h, u_f)
                for k, (b, ok) in enumerate(zip(attempt, tv.success.tolist())):  # a host read
                    if not ok:
                        continue
                    z = torch.where(tv.tri_mask[k], tv.points3d[k, :, 2], torch.nan)
                    med = torch.nanquantile(z, 0.5)
                    med = torch.where(torch.isfinite(med) & (med > 1e-6), med, 1.0)
                    mp[b] = tv.points3d[k] / med
                    md[b] = kps.desc[b][i2[k, :, 0]]
                    mv[b] = tv.tri_mask[k]
                    R_new[b], t_new[b] = tv.R21[k], tv.t21[k] / med
                    vel_R[b], vel_t[b] = eye, 0.0
                    new_state[b], init_frame[b] = 2, f
            working = [b for b in range(B) if state[b] == 2]
            if working:
                w = torch.tensor(working, device=dev)
                use = torch.tensor([have_vel[b] for b in working], device=dev)
                Rw, tw = R[w], t[w]
                R_pred = torch.where(use[:, None, None], vel_R[w] @ Rw, Rw)
                t_pred = torch.where(use[:, None], _matvec(vel_R[w], tw) + vel_t[w], tw)
                r = self.step.track(_index_batch(kps, w), xy_un[w], mp[w], md[w], mv[w],
                                    zn[w], zd[w], zd[w], R_pred, t_pred, Rw, tw, K)
                R_new[w], t_new[w] = r.R, r.t
                vel_R[w] = r.R @ Rw.transpose(-1, -2)
                vel_t[w] = r.t - _matvec(vel_R[w], tw)
                n_out[w] = r.n_matches2
                for b in working:
                    have_vel[b] = True
            for b in range(B):
                if state[b] != 2 and new_state[b] == 2:
                    have_vel[b] = False
            state, R, t = new_state, R_new, t_new
            Rs.append(R)
            ts.append(t)
            states.append(list(state))
            n_outs.append(n_out)
        return {
            "initialized": torch.tensor([s == 2 for s in state], device=dev),
            "init_frame": torch.tensor(init_frame, dtype=torch.int32, device=dev),
            "map_pts": mp, "map_desc": md, "map_valid": mv,
            "R": torch.stack(Rs, dim=1), "t": torch.stack(ts, dim=1),
            "state": torch.tensor(states, dtype=torch.int32, device=dev).T.contiguous(),
            "n_matches": torch.stack(n_outs, dim=1),
        }


def make_multiseq_init_runner(cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                              matcher_cfg: MatcherConfig, tracker_cfg: TrackerConfig,
                              init_cfg: InitConfig, point_capacity: int = 512,
                              device: torch.device | str = DEFAULT_DEVICE,
                              group: Optional[torch.distributed.ProcessGroup] = None
                              ) -> MultiseqInitRunner:
    """The device-side bootstrap of B sequences (see ``MultiseqInitRunner``);
    with a ``group``, each rank's B/D sequences (see the module docstring),
    their draws those of their place in the whole batch."""
    return MultiseqInitRunner(cam_cfg, orb_cfg, matcher_cfg, tracker_cfg, init_cfg,
                              point_capacity, device, group)


def make_multiseq_mapping_runner(cam_cfg: CameraConfig, orb_cfg: OrbConfig,
                                 matcher_cfg: MatcherConfig, tracker_cfg: TrackerConfig,
                                 tri_cap: int = 128, obs_cap: int = 512,
                                 device: torch.device | str = DEFAULT_DEVICE,
                                 group: Optional[torch.distributed.ProcessGroup] = None):
    """B sequences with growing maps (``multiseq.py:373-420``): the
    device-side mapping loop with the closed-form solve, called with a
    leading [B]. With a ``group``, each rank runs its B/D sequences (a
    rank's one sequence is still a batch of one) and the final maps and
    outputs are all-gathered.

    ``run(images [B,T,H,W], m0: SlamMap with a leading [B] on every
    field, R0 [B,3,3], t0 [B,3], K [3,3], frame_id0, kf_count0,
    kf_ref_inliers0: B ints each) -> (SlamMap [B, ...], DeviceLoopOutputs
    [B, T, ...])``: the tracking step batched, one host read of the [B]
    "held / keyframe due" flags a frame, and the recovery tier and the
    keyframe insert only for the sequences that need them, on their rows
    of the map (see ``DeviceSequenceLoop``)."""
    loop = DeviceSequenceLoop(cam_cfg, orb_cfg, matcher_cfg, tracker_cfg, tri_cap, obs_cap,
                              batched_solve=True, device=device)
    if group is None:
        return loop
    return _dp(group, loop, shared=(4,))
