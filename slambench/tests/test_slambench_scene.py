"""The device renderer against its frozen one-point-at-a-time numpy copy."""

import numpy as np
import torch

from slambench import scene
from slambench.reference.render_numpy import render_frame


def test_renderer_matches_numpy_copy():
    f = scene.make_field(np.random.default_rng(5), 250, (-6, 6), (-3, 3), (3, 9))
    path = scene.base_trajectory(40, "strafe")
    poses = [scene.offset_pose(*path[i], np.array([0.2, -0.05, 0.1], np.float32), 1.5)
             for i in (0, 17, 39)] + [path[5]]
    K = (267.7, 269.6, 160.05, 123.8)
    R = torch.tensor(np.stack([p[0] for p in poses]))
    t = torch.tensor(np.stack([p[1] for p in poses]))
    got = scene.render(f, K, 320, 240, R, t, chunk=3)
    for i, (Ri, ti) in enumerate(poses):
        ref = render_frame(f.pts, f.size_m, f.blob_off, f.blob_amp, f.blob_sig, *K, 320, 240,
                           Ri, ti)
        assert np.abs(got[i].numpy() - ref).max() < 1e-3
        # 8-bit rounding moves a value only where the two sit across a .5
        flips = (scene.quantize(got[i]).numpy() != np.round(ref)).sum()
        assert flips <= 5


def test_renderer_repeats_bit_for_bit():
    f = scene.make_field(np.random.default_rng(6), 200, (-6, 6), (-3, 3), (3, 9))
    path = scene.base_trajectory(10, "forward")
    R = torch.tensor(np.stack([p[0] for p in path[:4]]))
    t = torch.tensor(np.stack([p[1] for p in path[:4]]))
    K = (300.0, 300.0, 160.0, 120.0)
    assert torch.equal(scene.render(f, K, 320, 240, R, t, chunk=2),
                       scene.render(f, K, 320, 240, R, t, chunk=4))
