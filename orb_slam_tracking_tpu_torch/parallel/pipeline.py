"""Pipeline-parallel tracking: extraction and pose tracking as two stages
on the two ranks of a process group (counterpart of
``parallel/pipeline.py``).

The two halves of the fused tracking step (``slam/fused_step.py``) run on
two ranks, each on its own device, and a frame stream flows through them
GPipe-style:

  step k:   stage 0 extracts frame k          (B1, B4f)
            stage 1 tracks   frame k-1        (two projection matches, B3f,
                                               and two pose LMs)
            broadcast: keypoints stage 0 -> stage 1

so in the steady state both ranks are busy every step and the stream's
rate is ``1 / max(stage time)`` in place of ``1 / sum``. Extraction is
stateless per frame and runs ahead; the sequential dependency of SLAM,
the constant-velocity carry, lives on stage 1 alone.

Where the JAX module runs one ``shard_map`` program whose ``lax.switch``
selects each device's stage and ``ppermute``s the fixed-capacity
keypoint buffer one stage along per ``scan`` step, each rank here runs
its own stage's loop, and the buffer (the ``Keypoints`` fields and the
undistorted pixels, packed in one float32 and one int32 tensor) moves by
``dist.broadcast`` from stage 0 over the 2-rank group. Step 0 is the fill
bubble: stage 1 has nothing to track and keeps the initial state (JAX
computes on its dummy buffer and discards the result); at step T stage 0
has nothing left to extract. The [T] results end on both ranks by a
broadcast from stage 1 (JAX's zero-fill and ``psum``).

The map is held static during the stream; keyframe work happens between
streams. ``track_sequential`` is the same step and carry one frame after
another on one device, the reference the pipeline is held to.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..config import CameraConfig, MatcherConfig, OrbConfig, TrackerConfig
from ..device import DEFAULT_DEVICE, resolve_device
from ..slam.fused_step import TrackingStep
from ..types import Keypoints
from .distributed import broadcast, group_rank_size

__all__ = ["PipelineResult", "PipelinedTracker", "make_pipelined_tracker", "track_sequential"]

N_STAGES = 2


class PipelineResult(NamedTuple):
    R: torch.Tensor          # [T, 3, 3] optimised world-to-camera poses
    t: torch.Tensor          # [T, 3]
    n_inliers: torch.Tensor  # [T] int32
    n_matches: torch.Tensor  # [T] int32 (the tight stage's matches)
    n_kps: torch.Tensor      # [T] int32 keypoints extracted for the frame


def _track_frame(step: TrackingStep, kps: Keypoints, xy_un, maps, state, K):
    """One frame of stage 1: the fused step's track half from the
    constant-velocity prediction (``state = (R, t, velocity or None)``),
    as the host tracker's WORKING state. -> (new state, outputs)."""
    R, t, vel = state
    R_pred, t_pred = (R, t) if vel is None else (vel[0] @ R, vel[0] @ t + vel[1])
    r = step.track(kps, xy_un, *maps, R_pred, t_pred, R, t, K)
    vel_R = r.R @ R.T
    return (r.R, r.t, (vel_R, r.t - vel_R @ t)), (r.R, r.t, r.n_inliers, r.n_matches2, r.n_kps)


def _stacked(outs) -> PipelineResult:
    return PipelineResult(*(torch.stack(x) for x in zip(*outs)))


def track_sequential(step: TrackingStep, frames, map_pts, map_desc, map_valid, map_normal,
                     map_dmin, map_dmax, R0, t0, K) -> PipelineResult:
    """The pipeline's work one frame after another on one device: extract,
    then track with the same carry."""
    maps = (map_pts, map_desc, map_valid, map_normal, map_dmin, map_dmax)
    state, outs = (R0, t0, None), []
    for f in range(frames.shape[0]):
        kps, xy_un = step.extract(frames[f])
        state, out = _track_frame(step, kps, xy_un, maps, state, K)
        outs.append(out)
    return _stacked(outs)


def _pack(kps: Keypoints, xy_un: torch.Tensor):
    """The in-flight buffer as one [N, 7] float32 and one [N, 10] int32."""
    f = torch.cat([kps.xy, kps.response[:, None], kps.angle_deg[:, None], kps.size[:, None],
                   xy_un], dim=1)
    i = torch.cat([kps.octave[:, None], kps.desc, kps.valid[:, None].to(torch.int32)], dim=1)
    return f.contiguous(), i.contiguous()


def _unpack(f: torch.Tensor, i: torch.Tensor):
    """``_pack``'s fields again, each a contiguous copy (the kernels take
    contiguous tensors, and the next broadcast overwrites the buffer)."""
    kps = Keypoints(*(x.contiguous() for x in (f[:, 0:2], f[:, 2], f[:, 3], i[:, 0], f[:, 4],
                                               i[:, 1:9])), valid=i[:, 9].bool())
    return kps, f[:, 5:7].contiguous()


class PipelinedTracker:
    """The 2-stage tracking stream on this rank (see the module docstring).

    ``run(frames [T,H,W], map_pts [P,3], map_desc [P,8] int32, map_valid
    [P], map_normal [P,3], map_dmin [P], map_dmax [P], R0 [3,3], t0 [3], K
    [3,3]) -> PipelineResult`` (length T), called on both ranks with the
    same arguments on each rank's device; stage 0 reads only ``frames``.
    Frame k's pose comes one step after its extraction. ``stage`` is this
    rank's stage; ``stage_s``, the host seconds of the last run's stage
    work (extraction or tracking, the broadcasts excluded)."""

    def __init__(self, group: Optional[dist.ProcessGroup], cam_cfg: CameraConfig,
                 orb_cfg: OrbConfig, matcher_cfg: MatcherConfig, tracker_cfg: TrackerConfig,
                 device: torch.device | str = DEFAULT_DEVICE):
        device = resolve_device(device)
        self.stage, size = group_rank_size(group, device)
        if size != N_STAGES:
            raise ValueError(f"the pipeline needs a group of exactly {N_STAGES} ranks "
                             f"(extract | track), got {size}")
        self.group = group
        self.step = TrackingStep(cam_cfg, orb_cfg, matcher_cfg, tracker_cfg, device=device)
        self.stage_s = 0.0

    def __call__(self, frames, map_pts, map_desc, map_valid, map_normal, map_dmin, map_dmax,
                 R0, t0, K) -> PipelineResult:
        T, dev = frames.shape[0], frames.device
        n = self.step.orb_cfg.max_keypoints
        maps = (map_pts, map_desc, map_valid, map_normal, map_dmin, map_dmax)
        buf = (torch.zeros((n, 7), device=dev), torch.zeros((n, 10), dtype=torch.int32,
                                                            device=dev))
        state, outs, busy = (R0, t0, None), [], 0.0
        for k in range(T + 1):
            t_start = time.perf_counter()
            if self.stage == 0 and k < T:
                buf = _pack(*self.step.extract(frames[k]))
            elif self.stage == 1 and k >= 1:
                # k == 0 is the fill bubble: nothing in flight, the initial
                # state is kept
                state, out = _track_frame(self.step, *_unpack(*buf), maps, state, K)
                outs.append(out)
            busy += time.perf_counter() - t_start
            if k < T:
                for x in buf:
                    broadcast(x, 0, self.group)
        self.stage_s = busy
        # stage 1's [T] rows to both ranks
        if self.stage == 1:
            res = _stacked(outs)
            fl = torch.cat([res.R.reshape(T, 9), res.t], dim=1).contiguous()
            it = torch.stack([res.n_inliers, res.n_matches, res.n_kps], dim=1).to(torch.int32)
        else:
            fl = torch.zeros((T, 12), dtype=R0.dtype, device=dev)
            it = torch.zeros((T, 3), dtype=torch.int32, device=dev)
        for x in (fl, it):
            broadcast(x, 1, self.group)
        return PipelineResult(fl[:, :9].reshape(T, 3, 3), fl[:, 9:].contiguous(), it[:, 0],
                              it[:, 1], it[:, 2])


def make_pipelined_tracker(group: Optional[dist.ProcessGroup], cam_cfg: CameraConfig,
                           orb_cfg: OrbConfig, matcher_cfg: MatcherConfig,
                           tracker_cfg: TrackerConfig,
                           device: torch.device | str = DEFAULT_DEVICE) -> PipelinedTracker:
    """The 2-stage pipelined tracking stream over ``group`` (None = the
    default group), which must hold exactly 2 ranks (``ValueError``
    otherwise): group rank 0 extracts, rank 1 tracks."""
    return PipelinedTracker(group, cam_cfg, orb_cfg, matcher_cfg, tracker_cfg, device)

