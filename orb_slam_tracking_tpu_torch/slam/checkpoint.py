"""Checkpoint and resume of the tracker (counterpart of
``slam/checkpoint.py``), in the JAX package's version-4 ``.npz`` format,
so a JAX tracker's checkpoint resumes in the port and the port's in the
JAX package.

The map's fields are stored as ``map_<field>`` with the JAX package's
dtypes (descriptor words as uint32), beside the pose, velocity,
bookkeeping and trajectory. The port has no BoW yet: a checkpoint that
carries a vocabulary (``vocab_*``) or a keyframe database (``kfdb_*``)
raises ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np

from ..convert import slam_map_from_numpy, slam_map_to_numpy
from .tracker import TrackState, Tracker

__all__ = ["save_tracker", "load_tracker"]

_FORMAT_VERSION = 4  # v4: per-point viewing statistics (normal/dmin/dmax)


def save_tracker(tracker: Tracker, path: str) -> None:
    """Write the map, pose, velocity, trajectory and bookkeeping."""
    data = {f"map_{k}": v for k, v in slam_map_to_numpy(tracker.map).items()}
    traj = tracker.trajectory
    data.update(
        version=np.int32(_FORMAT_VERSION),
        state=np.int32(tracker.state),
        frame_id=np.int32(tracker.frame_id),
        R=tracker.R, t=tracker.t, vel_R=tracker.vel_R, vel_t=tracker.vel_t,
        have_velocity=np.bool_(tracker.have_velocity),
        frames_since_kf=np.int32(tracker.frames_since_kf),
        n_kf=np.int32(tracker.n_kf),
        kf_insert_count=np.int32(tracker.kf_insert_count),
        last_kf_slot=np.int32(tracker.last_kf_slot),
        kf_ref_inliers=np.int32(tracker.kf_ref_inliers),
        traj_frame_id=np.asarray([f for f, *_ in traj], np.int32),
        traj_ts=np.asarray([ts for _, ts, *_ in traj], np.float64),
        traj_R=np.asarray([R for _, _, R, _ in traj], np.float32).reshape(-1, 3, 3),
        traj_t=np.asarray([t for *_, t in traj], np.float32).reshape(-1, 3),
    )
    np.savez_compressed(path, **data)


def load_tracker(tracker: Tracker, path: str) -> Tracker:
    """Restore a ``save_tracker`` checkpoint (of either package) into a
    fresh Tracker built with the same SystemConfig; returns it."""
    z = np.load(path, allow_pickle=False)
    version = int(z["version"])
    if version != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint version {version}")
    bow = sorted(k for k in z.files if k.startswith(("vocab_", "kfdb_")))
    if bow:
        raise NotImplementedError(
            f"the checkpoint carries BoW state ({', '.join(bow[:3])}, ...); BoW comes "
            "with a later slice of the port")
    tracker.map = slam_map_from_numpy(
        {k[len("map_"):]: z[k] for k in z.files if k.startswith("map_")},
        device=tracker.device)
    tracker.state = int(z["state"])
    tracker.frame_id = int(z["frame_id"])
    tracker.R = z["R"]
    tracker.t = z["t"]
    tracker.vel_R = z["vel_R"]
    tracker.vel_t = z["vel_t"]
    tracker.have_velocity = bool(z["have_velocity"])
    tracker.frames_since_kf = int(z["frames_since_kf"])
    tracker.n_kf = int(z["n_kf"])
    tracker.kf_insert_count = int(z["kf_insert_count"])
    tracker.last_kf_slot = int(z["last_kf_slot"])
    tracker.kf_ref_inliers = int(z["kf_ref_inliers"])
    tracker.trajectory = [
        (int(f), float(ts), R, t)
        for f, ts, R, t in zip(z["traj_frame_id"], z["traj_ts"], z["traj_R"], z["traj_t"])]
    if tracker.state == TrackState.INITIALIZING:
        # the reference frame is not stored; seeding restarts
        tracker.state = TrackState.NOT_INITIALIZED
        tracker.ref = None
    return tracker
