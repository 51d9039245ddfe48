"""Harris ranking's initialization frame, the port's host tracker beside the
JAX package's, on the CPU, with JAX's draws handed over (ROADMAP C10).

The first frames of the 300-frame ``loop`` sequence as
``tools/make_synthetic_tum.py`` writes it (8-bit PNGs, read back), at its
settings (640x480, 1000 features) with ``score_type="harris"``; the
tracker at the demo's map size (2048 points, 16 keyframes) with BoW and
loop closing off, none of which an initialization attempt reads. On the card the port had initialized at frame index 37
where JAX does at 8 (``eval_tum`` prints ``[9]``), though both saw the same
scene there; the port on the CPU, with its CPU generator's draws, took
index 8. With the JAX tracker's own uniforms handed to
``Tracker._uniforms`` the port takes JAX's decision on every attempt: the
card's late start is the draws' (ROADMAP C2), not Harris ranking's.
"""

import dataclasses

import jax
import numpy as np
import pytest
from PIL import Image

from orb_slam_tracking_tpu.slam.tracker import Tracker as JxTracker
from orb_slam_tracking_tpu_torch.config import OrbConfig, SystemConfig, TrackerConfig
from orb_slam_tracking_tpu_torch.slam.tracker import Tracker
from orb_slam_tracking_tpu_torch.tools.make_synthetic_tum import make_sequence
from test_torch_tracker import JaxDraws, jx_cfg

FRAMES = 11  # JAX initializes at index 8 ([9]) with its draws


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    out = tmp_path_factory.mktemp("loop")
    cam = make_sequence(str(out), frames=300, mode="loop", first=FRAMES)
    names = sorted((out / "rgb").iterdir(), key=lambda p: float(p.stem))
    return cam, [np.asarray(Image.open(p), np.float32) for p in names]


def test_harris_init_takes_jax_decision_with_jax_draws(frames):
    """Attempt by attempt the same outcome and match count; both
    initialize at index 8 with the same model, and the port's
    initialized pose is within 1e-3 of JAX's."""
    cam, imgs = frames
    cfg = SystemConfig(camera=dataclasses.replace(cam, fps=30.0),
                       orb=OrbConfig(n_features=1000, score_type="harris"),
                       tracker=TrackerConfig(max_map_points=2048, max_keyframes=16,
                                             ba_window=8, use_bow=False,
                                             use_loop_closing=False))
    jx = JxTracker(jx_cfg(cfg))
    port = Tracker(cfg, device="cpu")
    port._uniforms = JaxDraws(jax.random.PRNGKey(0))
    init = {}
    for i, img in enumerate(imgs):
        mj = jx.track(img, i / 30.0)
        mp = port.track(img, i / 30.0)
        assert mp.get("init") == mj.get("init"), (i, mp, mj)
        assert mp.get("n_matches") == mj.get("n_matches"), (i, mp, mj)
        if mj.get("init") == "success":
            init = {"frame": i, "jax": mj, "port": mp}
            break
    assert init and init["frame"] == 8, init
    assert init["port"]["used_h"] == init["jax"]["used_h"]
    np.testing.assert_allclose(np.asarray(port.R), np.asarray(jx.R), atol=1e-3)
