"""The control of every cell's comparison: the plain reference computed one
precision below the float32 the configurations state (TF32 on), put in
the program's place, has to come out not correct. TF32 exists only on
the card. The localization cells' configurations run as they are but
for 8 streams (the cells take 256 and 128); global BA at 64 keyframes
and 8,192 points. The cell-size readings come from ``python -m
slambench.limits`` on the card (PERF.md)."""

import pytest
import torch

from slambench.cells import BENCH, load_settings, load_traffic
from slambench.mixes.global_ba import GlobalBA
from slambench.mixes.localization import Localization
from slambench.run import judge
from slambench.tests.small import small_ba


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on a CUDA device")


@pytest.mark.card
@pytest.mark.parametrize("config", ["tum3-mono", "kitti-mono"])
@pytest.mark.parametrize("seed", [11, 2 ** 31 + 12, 13])
def test_localization_control_is_not_correct(config, seed):
    _need_card()
    s, mix = load_settings(BENCH / "configs" / f"{config}.yaml"), load_traffic("loc-batch")
    mix["check_streams"] = 8
    d = Localization(s, mix, seed, "cuda", streams=8)
    d.inputs()
    assert not judge(d.control(), mix["limits"], 0)


@pytest.mark.card
@pytest.mark.parametrize("seed", [21, 2 ** 31 + 22, 23])
def test_global_ba_control_is_not_correct(seed):
    _need_card()
    s, mix = small_ba()
    s.update({"Bench.gbaKeyframes": 64, "Bench.gbaPoints": 8192})
    d = GlobalBA(s, mix, seed, "cuda")
    d.inputs()
    assert not judge(d.control(), mix["limits"], 0)
