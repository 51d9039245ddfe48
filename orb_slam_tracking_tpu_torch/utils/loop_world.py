"""A drifted loop that loop closing must close (the port's copy of the
``loop_world`` fixture of the JAX package's ``tests/test_loop_closing.py``).

A camera circles a ring of 150 landmarks in 10 keyframes. Odometry drift
deforms the estimated world (a Sim(3) step composed per keyframe from the
third on, frozen for the last), so the revisited region is mapped again as
duplicate points: the revisit (keyframe 9) shares no map point with the
loop keyframe (0), yet BoW place recognition must find it, Sim(3) recover
the drift from the duplicated structure, and the correction pull the
trajectory back.

``uv_from_gt=False``: the measurements are projections through the
drifted geometry (the drifted map is an exact reprojection minimum);
``True``: projections of the true landmarks through the true cameras,
with the drift only in the estimates. The scene is built in f32 on the
CPU with the port's Sim(3) ops, the vocabulary (k = 8, depth 2) is trained
on the landmarks' descriptors, and the map and database are then put on
``device``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..bow.database import add_keyframe, empty_database
from ..bow.vocabulary import build_vocabulary, transform
from ..config import CameraConfig, SystemConfig, TrackerConfig
from ..geometry.sim3 import Sim3, sim3_apply, sim3_compose, sim3_inverse
from ..slam.map import empty_map

__all__ = ["N_KF", "N_LM", "loop_world_config", "build_loop_world", "center_errors", "centers"]

N_KF = 10
N_LM = 150
WINDOW_DEG = 55.0
KF_CAP, PT_CAP, KP_CAP = 16, 512, 128


def loop_world_config(loop_global_ba_iterations: int = 0) -> SystemConfig:
    """The fixture's configuration: 16 keyframes, 512 points, loop gates
    sized to its ten keyframes; global BA off unless asked for."""
    return SystemConfig(
        camera=CameraConfig(fx=300.0, fy=300.0, cx=320.0, cy=240.0),
        tracker=TrackerConfig(
            max_keyframes=KF_CAP, max_map_points=PT_CAP, covis_min_shared=5,
            loop_min_frame_gap=5, loop_consistency_th=1, loop_min_inliers=10,
            loop_covis_edge_min_shared=8,
            loop_global_ba_iterations=loop_global_ba_iterations))


def _look_at(c):
    """World-to-camera rotation of a camera at ``c`` looking at the origin."""
    z = -c / np.linalg.norm(c)
    x = np.cross([0.0, 0.0, 1.0], z)
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def _ang_dist(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _rz(th):
    c, s = np.cos(th), np.sin(th)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _sim3(s, R, t) -> Sim3:
    return Sim3(s=torch.tensor(np.float32(s)), R=torch.tensor(np.asarray(R, np.float32)),
                t=torch.tensor(np.asarray(t, np.float32)))


def build_loop_world(uv_from_gt: bool = False, device: torch.device | str = "cpu") -> dict:
    """-> dict(cfg, K, m, db, voc, R_gt, t_gt, S_hat, s_drift): the config,
    the intrinsics (numpy), the drifted map, the BoW database and its
    vocabulary (on ``device``), the ground-truth world-to-camera poses, the drifted
    similarity estimates (CPU) and the accumulated drift scale."""
    rng = np.random.default_rng(7)
    cfg = loop_world_config()
    K = np.array([[300.0, 0, 320.0], [0, 300.0, 240.0], [0, 0, 1]], np.float32)

    # the ground-truth ring of landmarks and circular trajectory
    phi = rng.uniform(0, 2 * np.pi, N_LM)
    X_true = np.stack([2.0 * np.cos(phi), 2.0 * np.sin(phi), rng.uniform(-0.8, 0.8, N_LM)],
                      axis=1)
    desc = rng.integers(0, 2 ** 32, (N_LM, 8), dtype=np.uint64).astype(np.uint32)
    a_k = 2 * np.pi * np.arange(N_KF) / N_KF
    R_gt = np.zeros((N_KF, 3, 3), np.float32)
    t_gt = np.zeros((N_KF, 3), np.float32)
    for k in range(N_KF):
        c = np.array([8 * np.cos(a_k[k]), 8 * np.sin(a_k[k]), 0.0])
        R_gt[k] = _look_at(c)
        t_gt[k] = -R_gt[k] @ c

    # world-side drift G_k (growing for k = 2..8, G_9 = G_8)
    step = _sim3(1.05, _rz(0.02), [0.08, -0.05, 0.03])
    G = [_sim3(1.0, np.eye(3), np.zeros(3))] * 2
    for _ in range(2, N_KF - 1):
        G.append(sim3_compose(step, G[-1]))
    G.append(G[-1])
    S_hat = [sim3_compose(_sim3(1.0, R_gt[k], t_gt[k]), G[k]) for k in range(N_KF)]

    # visibility, split into runs of consecutive keyframes: one map-point
    # instance per run
    vis = _ang_dist(phi[None, :], a_k[:, None]) < np.deg2rad(WINDOW_DEG)
    instances = []
    for lm in range(N_LM):
        ks = np.where(vis[:, lm])[0]
        if len(ks) == 0:
            continue
        run = [int(ks[0])]
        for k in ks[1:]:
            if k == run[-1] + 1:
                run.append(int(k))
            else:
                instances.append((lm, run))
                run = [int(k)]
        instances.append((lm, run))
    if len(instances) > PT_CAP:
        raise AssertionError(f"{len(instances)} instances exceed {PT_CAP} points")

    pts = np.zeros((PT_CAP, 3), np.float32)
    pdesc = np.zeros((PT_CAP, 8), np.uint32)
    pvalid = np.zeros(PT_CAP, bool)
    nobs = np.zeros(PT_CAP, np.int32)
    kp_xy = np.zeros((KF_CAP, KP_CAP, 2), np.float32)
    kp_desc = np.zeros((KF_CAP, KP_CAP, 8), np.uint32)
    kp_valid = np.zeros((KF_CAP, KP_CAP), bool)
    kp_pt = np.full((KF_CAP, KP_CAP), -1, np.int32)
    kp_count = np.zeros(KF_CAP, int)
    obs = []  # (kf, pt, kp, uv)
    for inst, (lm, run) in enumerate(instances):
        Xh = sim3_apply(sim3_inverse(G[run[0]]),
                        torch.tensor(X_true[lm][None].astype(np.float32))).numpy()[0]
        pts[inst] = Xh
        pdesc[inst] = desc[lm]
        pvalid[inst] = True
        nobs[inst] = len(run)
        for k in run:
            if uv_from_gt:
                xc = R_gt[k] @ X_true[lm] + t_gt[k]
            else:
                xc = S_hat[k].R.numpy() @ Xh + S_hat[k].t.numpy()
            uv = (K[:2, :2] @ (xc[:2] / xc[2]) + K[:2, 2]).astype(np.float32)
            j = kp_count[k]
            kp_count[k] += 1
            kp_xy[k, j] = uv
            kp_desc[k, j] = desc[lm]
            kp_valid[k, j] = True
            kp_pt[k, j] = inst
            obs.append((k, inst, j, uv))

    O = len(obs)
    m = empty_map(cfg.tracker, KP_CAP, device)
    dev = m.pts.device

    def put(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    def head(x, vals):
        return torch.cat([put(vals).to(x.dtype), x[O:]])

    # the map keeps SE(3) poses: in the physical regime the [R, t/s]
    # write-back of the drift similarity, else its raw parts
    kf_t = [S.t.numpy() / (float(S.s) if uv_from_gt else 1.0) for S in S_hat]
    m = m._replace(
        pts=put(pts), desc=put(pdesc.view(np.int32)), pt_valid=put(pvalid), n_obs=put(nobs),
        kf_R=put(np.stack([S.R.numpy() for S in S_hat] + [np.eye(3, dtype=np.float32)] * 6)),
        kf_t=put(np.stack(kf_t + [np.zeros(3, np.float32)] * 6)),
        kf_valid=put(np.arange(KF_CAP) < N_KF),
        kf_frame_id=put(np.concatenate([np.arange(N_KF), np.full(6, -1)]).astype(np.int32)),
        kf_kp_xy=put(kp_xy), kf_kp_desc=put(kp_desc.view(np.int32)),
        kf_kp_valid=put(kp_valid), kf_kp_pt=put(kp_pt),
        obs_kf=head(m.obs_kf, [o[0] for o in obs]), obs_pt=head(m.obs_pt, [o[1] for o in obs]),
        obs_kp=head(m.obs_kp, [o[2] for o in obs]),
        obs_uv=head(m.obs_uv, np.stack([o[3] for o in obs])),
        obs_valid=head(m.obs_valid, np.ones(O, bool)))

    # the BoW database over the keyframe snapshots
    voc = build_vocabulary(desc, k=8, depth=2, device="cpu")
    db = empty_database(KF_CAP, voc.n_words, "cpu")
    for k in range(N_KF):
        _, bow = transform(voc, torch.tensor(kp_desc[k].view(np.int32)),
                           torch.tensor(kp_valid[k]))
        db = add_keyframe(db, k, bow)
    db = type(db)(*(x.to(dev) for x in db))
    voc = voc._replace(node_desc=tuple(d.to(dev) for d in voc.node_desc),
                       word_weight=voc.word_weight.to(dev))
    return dict(cfg=cfg, K=K, m=m, db=db, voc=voc, R_gt=R_gt, t_gt=t_gt, S_hat=S_hat,
                s_drift=float(G[-1].s))


def centers(R, t) -> np.ndarray:
    """Camera centres ``-R^T t`` of world-to-camera poses [K, 3, 3], [K, 3]."""
    return -np.einsum("kij,ki->kj", np.asarray(R), np.asarray(t))


def center_errors(R, t, R_gt, t_gt) -> np.ndarray:
    return np.linalg.norm(centers(R, t) - centers(R_gt, t_gt), axis=-1)
