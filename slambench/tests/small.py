"""Small configurations of the benchmark's cells that a CPU test run can
hold: the same files, cut in image size, features, streams, clip and map
(the localization mix) or in keyframes and points (global BA)."""

from __future__ import annotations

from slambench.cells import BENCH, load_settings, load_traffic


def small_loc(streams: int = 8, frames: int = 3):
    s = load_settings(BENCH / "configs" / "tum3-mono.yaml")
    s.update({"Camera.width": 320, "Camera.height": 240, "Camera.fx": 267.7,
              "Camera.fy": 269.6, "Camera.cx": 160.05, "Camera.cy": 123.8,
              "ORBextractor.nFeatures": 300, "Bench.mapSlots": 384, "Bench.sceneCorners": 1200,
              "Bench.sceneX": [-7.0, 11.0], "Bench.stationX": [0.0, 5.0], "Bench.mapViews": 8,
              "Bench.streamsPerCard": streams})
    mix = load_traffic("loc-batch")
    mix.update(clip_frames=frames, check_streams=streams, check_block=4)
    return s, mix


def small_ba():
    s = load_settings(BENCH / "configs" / "kitti-mono.yaml")
    s.update({"Bench.gbaKeyframes": 12, "Bench.gbaPoints": 600})
    return s, load_traffic("global-ba")
