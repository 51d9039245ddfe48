"""The port's operating points.

``entry`` is the counterpart of ``__graft_entry__.entry()``: the fused
tracking step at the headline operating point (640x480, 1000 keypoints, an
8192-point map), with inputs drawn by the same ``default_rng(0)`` calls in
the same order, so both entries see the same arrays.

``init_entry`` is two-view initialization at the size the tracker runs it:
a rendered 640x480 pair of the corner-field scene on the strafe
trajectory, extracted at ``init_orb`` of 1000 features (2000 keypoints,
capacity 2048), with 200 RANSAC hypotheses per model.

``tracker_entry`` is the sequence tracker at the JAX package's tracking
demo point (``examples/demo_tracking.py``), its configuration exactly:
640x480, 1000 features, a 2048-point / 16-keyframe map with an 8-keyframe
BA window, every other field at its default (BoW with the bundled
vocabulary, loop closing), 40 rendered frames of the 900-point corner
field on the strafe trajectory.

``device_loop_entry`` is the device-side mapping loop at the JAX
package's sequence-throughput recipe (``scripts/tpu_seq_fps.py``, the
sequence metric of ``bench.py``): 640x480, 1000 features, an
8192-point / 24-keyframe map with an 8-keyframe BA window, the 1200-point
corner field over x in [-6, 6] on a 260-frame strafe, bootstrapped by the
port's ``Tracker`` until it is WORKING.

``multiseq_entry`` is the multi-sequence runner at the JAX package's DP
throughput recipe (``scripts/tpu_multiseq_fps.py``): ``device_loop_entry``'s
configuration, field, strafe and bootstrap, the bootstrapped map frozen and
given to each of B sequences. Where the JAX script tiles one sequence B
times, the port's sequences are distinct: sequence b starts
``MULTISEQ_STRIDE * b`` frames further along the strafe, from the pose a
one-sequence run reaches there.

``dryrun_multichip`` is the counterpart of
``__graft_entry__.dryrun_multichip``: ``world_size`` ranks over
``torch.distributed`` run one step of every multi-device mode at tiny
shapes: DP tracking across the ranks, the tensor-parallel matcher, the
two-stage pipeline (on ranks 0 and 1), the point-sharded BA, and the
init and mapping runners across the ranks.
"""

from __future__ import annotations

import functools
from typing import Callable, List, NamedTuple, Tuple

import numpy as np
import torch

from .config import (CameraConfig, InitConfig, MatcherConfig, OrbConfig,
                     SystemConfig, TrackerConfig)
from .convert import map_from_numpy
from .device import DEFAULT_DEVICE, resolve_device
from .parallel.multiseq import (make_multiseq_init_runner, make_multiseq_mapping_runner,
                                make_multiseq_sequence_runner, make_multiseq_step)
from .slam.device_mapping import DeviceSequenceLoop, make_device_sequence_loop
from .slam.fused_step import TrackingStep
from .slam.map import SlamMap, empty_map
from .slam.tracker import Tracker, TrackState
from .slam.two_view_init import TwoViewInitializer
from .utils.synthetic import CornerField, make_trajectory, render_frame

__all__ = ["entry", "init_entry", "tracker_entry", "device_loop_entry", "multiseq_entry",
           "dryrun_multichip",
           "InitEntry", "TrackerEntry", "DeviceLoopEntry", "MultiseqEntry", "ENTRY_CAMERA",
           "INIT_PAIR", "TRACKER_CONFIG", "DEVICE_LOOP_CONFIG", "MULTISEQ_STRIDE"]

ENTRY_CAMERA = CameraConfig(fx=450.0, fy=450.0, cx=320.0, cy=240.0,
                            width=640, height=480)
ENTRY_MAP_POINTS = 8192


def entry(device: torch.device | str = DEFAULT_DEVICE):
    """-> (forward, example_args): ``forward(*example_args)`` runs one step
    and returns (R, t, n_inliers, n_matches1, n_matches2)."""
    device = resolve_device(device)
    cam = ENTRY_CAMERA
    step = TrackingStep(cam, OrbConfig(n_features=1000), MatcherConfig(),
                        TrackerConfig(), device=device)

    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 640)).astype(np.float32)
    P = ENTRY_MAP_POINTS
    # synthetic in-frustum map (workload-shaped; content-independent)
    u = rng.uniform(40, cam.width - 40, P)
    v = rng.uniform(40, cam.height - 40, P)
    z = rng.uniform(4.0, 9.0, P).astype(np.float32)
    pts = np.stack([(u - cam.cx) / cam.fx * z, (v - cam.cy) / cam.fy * z, z],
                   -1).astype(np.float32)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    m = map_from_numpy(pts, desc, np.ones(P, bool), device=device)
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]],
                     dtype=torch.float32, device=device)
    R = torch.eye(3, device=device)
    t = torch.zeros(3, device=device)

    def forward(image, pts, desc, valid, normal, dmin, dmax, Rp, tp, K_):
        r = step(image, pts, desc, valid, normal, dmin, dmax, Rp, tp, Rp, tp, K_)
        return r.R, r.t, r.n_inliers, r.n_matches1, r.n_matches2

    return forward, (torch.tensor(img, device=device), m.pts, m.desc, m.valid,
                     m.normal, m.dmin, m.dmax, R, t, K)


# the init pair: frames 0 and 2 of make_trajectory(16, "strafe") (a 0.18
# baseline, 0.8 degrees of yaw) over a 400-point corner field 3-9 deep;
# ~118 matches, ~1.4 degrees of parallax
INIT_FIELD_POINTS = 400
INIT_FRAMES = 16
INIT_PAIR = (0, 2)


class InitEntry(NamedTuple):
    forward: Callable    # forward(img1, img2) -> InitPairResult
    args: Tuple          # (img1, img2) [480, 640] float32 on the device
    R21: np.ndarray      # ground-truth frame-1 -> frame-2 rotation
    t21: np.ndarray      # ground-truth translation (metric; init is up to scale)


def init_entry(device: torch.device | str = DEFAULT_DEVICE,
               init_cfg: InitConfig = InitConfig()) -> InitEntry:
    """Two-view initialization at its operating point. ``forward`` seeds
    its hypothesis generator with 0 on every call, so calls agree."""
    device = resolve_device(device)
    cfg = SystemConfig(camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
                       init=init_cfg)
    init = TwoViewInitializer(cfg.camera, cfg.init_orb, cfg.matcher, cfg.init,
                              device=device)
    field = CornerField(np.random.default_rng(7), n=INIT_FIELD_POINTS)
    poses = make_trajectory(INIT_FRAMES, "strafe")
    (R1, t1), (R2, t2) = (poses[i] for i in INIT_PAIR)
    imgs = tuple(torch.tensor(render_frame(field, cfg.camera, R, t), device=device)
                 for R, t in ((R1, t1), (R2, t2)))
    R21 = R2 @ R1.T
    t21 = t2 - R21 @ t1

    def forward(img1, img2):
        return init(img1, img2, torch.Generator(device=device).manual_seed(0))

    return InitEntry(forward, imgs, R21, t21)


# the tracking demo's configuration
TRACKER_CONFIG = SystemConfig(
    camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
    tracker=TrackerConfig(max_map_points=2048, max_keyframes=16, ba_window=8))
TRACKER_FIELD_POINTS = 900
TRACKER_FRAMES = 40


class TrackerEntry(NamedTuple):
    tracker: Tracker
    frames: List[np.ndarray]                     # [480, 640] float32 images
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground-truth world-to-camera (R, t)


def tracker_entry(device: torch.device | str = DEFAULT_DEVICE,
                  n_frames: int = TRACKER_FRAMES) -> TrackerEntry:
    """A fresh ``Tracker`` at the tracking demo's point, the rendered frames
    (``CornerField(default_rng(0), n=900)``, ``make_trajectory(n_frames,
    "strafe")``) and their ground-truth poses. Feed frame i with timestamp
    i / 30."""
    device = resolve_device(device)
    field = CornerField(np.random.default_rng(0), n=TRACKER_FIELD_POINTS)
    poses = make_trajectory(n_frames, "strafe")
    frames = [render_frame(field, TRACKER_CONFIG.camera, R, t) for R, t in poses]
    return TrackerEntry(Tracker(TRACKER_CONFIG, device=device), frames, poses)


# scripts/tpu_seq_fps.py's recipe, unchanged (BoW and loop closing off, as
# there)
DEVICE_LOOP_CONFIG = SystemConfig(
    camera=ENTRY_CAMERA, orb=OrbConfig(n_features=1000),
    tracker=TrackerConfig(max_map_points=8192, max_keyframes=24, ba_window=8,
                          use_bow=False, use_loop_closing=False))
DEVICE_LOOP_FIELD_POINTS = 1200
DEVICE_LOOP_FIELD_X = (-6.0, 6.0)
DEVICE_LOOP_TRAJECTORY = 260
DEVICE_LOOP_CAPS = {"tri_cap": 128, "obs_cap": 512}


class DeviceLoopEntry(NamedTuple):
    loop: DeviceSequenceLoop
    args: Tuple      # (m0, R0, t0, K, frame_id0, kf_count0, kf_ref_inliers0): the loop's state
    frames: torch.Tensor                         # [n_frames, 480, 640] float32 on the device
    boot_end: int                                # the trajectory index of frames[0]
    poses: List[Tuple[np.ndarray, np.ndarray]]   # ground truth of the whole trajectory


def device_loop_entry(device: torch.device | str = DEFAULT_DEVICE,
                      n_frames: int = 192) -> DeviceLoopEntry:
    """The device loop at the sequence recipe: the port's ``Tracker``
    tracks the rendered strafe until WORKING; ``loop(frames[:T], *args)``
    then runs the next ``T <= n_frames`` frames from its map and pose."""
    device = resolve_device(device)
    cfg = DEVICE_LOOP_CONFIG
    field = CornerField(np.random.default_rng(0), n=DEVICE_LOOP_FIELD_POINTS,
                        x=DEVICE_LOOP_FIELD_X)
    poses = make_trajectory(DEVICE_LOOP_TRAJECTORY, "strafe")
    tracker = Tracker(cfg, device=device)
    i = 0
    while tracker.state != TrackState.WORKING:
        if i + n_frames >= len(poses):
            raise RuntimeError(f"the bootstrap did not reach WORKING by frame {i}")
        tracker.track(render_frame(field, cfg.camera, *poses[i]), i / 30.0)
        i += 1
    frames = torch.tensor(np.stack([render_frame(field, cfg.camera, R, t)
                                    for R, t in poses[i:i + n_frames]]), device=device)
    loop = make_device_sequence_loop(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                     device=device, **DEVICE_LOOP_CAPS)
    args = (tracker.map, torch.tensor(tracker.R, device=device),
            torch.tensor(tracker.t, device=device), tracker.K, tracker.frame_id + 1,
            tracker.kf_insert_count, max(tracker.kf_ref_inliers, 1))
    return DeviceLoopEntry(loop, args, frames, i, poses)


MULTISEQ_STRIDE = 4  # frames between the starts of consecutive sequences


class MultiseqEntry(NamedTuple):
    run: Callable        # make_multiseq_sequence_runner's run on the device
    args: Tuple          # (map_pts [B,P,3], map_desc [B,P,8], map_valid [B,P], R0 [B,3,3],
                         #  t0 [B,3], K [3,3]): the frozen maps and each start pose
    frames: torch.Tensor  # [B, n_frames, 480, 640] float32: sequence b's frames
    starts: List[int]    # the trajectory index of each sequence's first frame
    loop_entry: DeviceLoopEntry  # the bootstrap (its map, pose, frames)


def multiseq_entry(device: torch.device | str = DEFAULT_DEVICE, batch: int = 4,
                   n_frames: int = 192, loop_entry: DeviceLoopEntry | None = None
                   ) -> MultiseqEntry:
    """B = ``batch`` distinct sequences of ``n_frames`` frames at the DP
    recipe: ``run(frames[:, :T], *args)`` tracks the first ``T`` of each.
    The bootstrap's map is given to every sequence; sequence b's first
    pose is what a one-sequence run from the bootstrap reaches on the frame
    before its start (sequence 0 starts from the bootstrap's pose).
    ``loop_entry``, a ``device_loop_entry`` with enough frames, saves the
    bootstrap."""
    device = resolve_device(device)
    cfg = DEVICE_LOOP_CONFIG
    lead = MULTISEQ_STRIDE * (batch - 1)
    e = loop_entry
    if e is None or e.frames.shape[0] < n_frames + lead:
        e = device_loop_entry(device, n_frames + lead)
    run = make_multiseq_sequence_runner(cfg.camera, cfg.orb, cfg.matcher, cfg.tracker,
                                        device=device)
    m, R, t, K = e.args[:4]
    maps = [x.expand((batch,) + x.shape).contiguous() for x in (m.pts, m.desc, m.pt_valid)]
    R0, t0 = [R], [t]
    if lead:
        head = run(e.frames[None, :lead], *(x[:1] for x in maps), R[None], t[None], K)
        for b in range(1, batch):
            R0.append(head["R"][0, MULTISEQ_STRIDE * b - 1])
            t0.append(head["t"][0, MULTISEQ_STRIDE * b - 1])
    frames = torch.stack([e.frames[MULTISEQ_STRIDE * b: MULTISEQ_STRIDE * b + n_frames]
                          for b in range(batch)])
    return MultiseqEntry(run, (*maps, torch.stack(R0), torch.stack(t0), K), frames,
                         [e.boot_end + MULTISEQ_STRIDE * b for b in range(batch)], e)


def _dryrun_rank(mesh) -> dict:
    """One rank of ``dryrun_multichip`` (``__graft_entry__.py:63-236``'s
    shapes: 96x128 frames, 32 features, an ``8 x world``-point map)."""
    import torch.distributed as dist

    from .parallel.ba_sharded import bucket_observations, bundle_adjust_sharded
    from .parallel.distributed import make_global_array, replicate
    from .parallel.matcher_sharded import match_descriptors_tp
    from .parallel.pipeline import make_pipelined_tracker

    dev, n = mesh.device, mesh.size
    rng = np.random.default_rng(0)
    H, W, B, Pcap = 96, 128, n, 8 * n
    ocfg = OrbConfig(n_features=32, n_levels=3, select_cell_size=8, max_keypoints=64)
    mcfg = MatcherConfig()
    cam = CameraConfig(fx=100.0, fy=100.0, cx=W / 2, cy=H / 2, width=W, height=H)
    K = torch.tensor([[100.0, 0, W / 2], [0, 100.0, H / 2], [0, 0, 1]], device=dev)
    images = torch.tensor(rng.uniform(0, 255, (B, H, W)).astype(np.float32), device=dev)
    map_pts = torch.tensor(np.stack([rng.uniform(-1, 1, (B, Pcap)), rng.uniform(-1, 1, (B, Pcap)),
                                     rng.uniform(2, 5, (B, Pcap))], -1).astype(np.float32),
                           device=dev)
    map_desc = torch.tensor(rng.integers(0, 2**32, (B, Pcap, 8), dtype=np.uint32).view(np.int32),
                            device=dev)
    map_valid = torch.ones((B, Pcap), dtype=torch.bool, device=dev)
    R = torch.eye(3, device=dev).expand(B, 3, 3).contiguous()
    t = torch.zeros((B, 3), device=dev)
    out = {}

    # DP tracking: B sequences, B / world on each rank
    step = make_multiseq_step(ocfg, mcfg, W, H, device=dev, group=mesh.group)
    out["dp_n_kps"] = step(images, map_pts, map_desc, map_valid, R, t, K).n_kps

    # the tensor-parallel matcher: sequence 0's map table sharded
    Nq = 16
    desc_q = torch.tensor(rng.integers(0, 2**32, (Nq, 8), dtype=np.uint32).view(np.int32),
                          device=dev)
    md0 = map_desc[0].cpu().numpy()
    out["tp_matches"] = match_descriptors_tp(
        desc_q, torch.ones(Nq, dtype=torch.bool, device=dev), make_global_array(mesh, md0),
        make_global_array(mesh, np.ones(Pcap, bool)), group=mesh.group)

    # the two-stage pipeline on ranks 0 and 1 (every rank forms the group)
    T = 3
    frames = torch.tensor(rng.uniform(0, 255, (T, H, W)).astype(np.float32), device=dev)
    if n >= 2:
        pp_group = dist.new_group([0, 1])
        if mesh.rank < 2:
            zp = torch.zeros((Pcap, 3), device=dev)
            zd = torch.zeros(Pcap, device=dev)
            run = make_pipelined_tracker(pp_group, cam, ocfg, mcfg, TrackerConfig(), device=dev)
            out["pp_R"] = run(frames, map_pts[0], map_desc[0], map_valid[0], zp, zd, zd,
                              torch.eye(3, device=dev), torch.zeros(3, device=dev), K).R

    # the point-sharded BA: 4 keyframes, every point seen from each
    nK, nP = 4, Pcap
    kf_R = np.broadcast_to(np.eye(3, dtype=np.float32), (nK, 3, 3))
    kf_t = np.stack([np.array([-0.1 * k, 0, 0], np.float32) for k in range(nK)])
    pts = map_pts[0].cpu().numpy()
    obs_kf = np.repeat(np.arange(nK), nP).astype(np.int32)
    obs_pt = np.tile(np.arange(nP), nK).astype(np.int32)
    pc = np.einsum("kij,pj->kpi", kf_R, pts) + kf_t[:, None, :]
    obs_uv = ((pc[..., :2] / pc[..., 2:]) * [100.0, 100.0] + [W / 2, H / 2]).reshape(-1, 2)
    O = nK * nP
    bk, bp, buv, bw, bv = bucket_observations(
        obs_kf, obs_pt, obs_uv.astype(np.float32), np.ones(O, np.float32), np.ones(O, bool),
        nP, n, O // n + 8)
    fixed = np.zeros(nK, bool)
    fixed[0] = True
    G = functools.partial(make_global_array, mesh)
    out["ba_cost"] = bundle_adjust_sharded(
        replicate(mesh, kf_R), replicate(mesh, kf_t), G(pts), G(bk), G(bp), G(buv), G(bw), G(bv),
        replicate(mesh, fixed), G(np.ones(nP, bool)), K, iterations=3, group=mesh.group)[3]

    # the device-side bootstrap: B sequences of T random frames, B / world
    # on each rank (``__graft_entry__.py:137-152``)
    init = make_multiseq_init_runner(cam, ocfg, mcfg, TrackerConfig(),
                                     InitConfig(min_matches=8, ransac_iterations=16),
                                     point_capacity=16, device=dev, group=mesh.group)
    seq = torch.tensor(rng.uniform(0, 255, (B, T, H, W)).astype(np.float32), device=dev)
    boot = init(seq, K, list(range(B)))
    out["init_state"], out["init_R"] = boot["state"], boot["R"]

    # B sequences with growing maps, each from sequence 0's map with
    # keyframe 0 valid (``__graft_entry__.py:154-181``)
    tcfg = TrackerConfig(max_map_points=Pcap, max_keyframes=4, ba_window=2, ba_iterations=1,
                         max_frames=2, min_tracked_inliers=4, use_loop_closing=False,
                         use_bow=False)
    mrun = make_multiseq_mapping_runner(cam, ocfg, mcfg, tcfg, tri_cap=8, obs_cap=16,
                                        device=dev, group=mesh.group)
    m1 = empty_map(tcfg, kp_capacity=ocfg.max_keypoints, device=dev)
    m1 = m1._replace(pts=map_pts[0], desc=map_desc[0], pt_valid=map_valid[0],
                     kf_valid=torch.arange(tcfg.max_keyframes, device=dev) == 0)
    mB = SlamMap(*(x.expand((B,) + x.shape).contiguous() for x in m1))
    seq2 = torch.tensor(rng.uniform(0, 255, (B, 2, H, W)).astype(np.float32), device=dev)
    m_out, loop_out = mrun(seq2, mB, R, t, K, [1] * B, [1] * B, [1] * B)
    out["map_R"], out["map_n_kps"] = loop_out.R, loop_out.n_kps
    out["map_inserted_kf"], out["map_pt_valid"] = loop_out.inserted_kf, m_out.pt_valid
    return out


def dryrun_multichip(world_size: int, backend: str = "nccl",
                     device: torch.device | str = DEFAULT_DEVICE) -> List[dict]:
    """``world_size`` spawned ranks in a ``backend`` group, rank r on
    ``device`` (``"cuda"``: the card ``r % device_count``), each running
    one step of every multi-device mode (``_dryrun_rank``). Returns each
    rank's outputs (numpy): ``dp_n_kps [world]``, ``tp_matches [16]``,
    ``pp_R [3, 3, 3]`` (ranks 0 and 1, when ``world_size >= 2``),
    ``ba_cost``, the init runner's ``init_state [world, 3]`` and ``init_R
    [world, 3, 3, 3]``, and the mapping runner's ``map_R [world, 2, 3,
    3]``, ``map_n_kps`` and ``map_inserted_kf [world, 2]`` and
    ``map_pt_valid [world, 8 x world]``."""
    from .parallel.distributed import spawn

    return spawn(_dryrun_rank, world_size, backend, device)
