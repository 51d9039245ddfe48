"""The comparison that decides ``correct`` against a timed path broken
underneath: the rest of a run driven on the CPU at a small size (the
harness's look for a card skipped), each fault the cell can have
planted where the answer is produced, and ``correct`` read false. The
cells run on one card, so no exchange between cards can be left out."""

import pytest
import torch

from slambench.mixes.global_ba import GlobalBA
from slambench.mixes.localization import Localization
from slambench.run import judge
from slambench.tests.small import small_ba, small_loc


@pytest.fixture(scope="module")
def loc():
    torch.manual_seed(0)
    s, mix = small_loc()
    d = Localization(s, mix, 2 ** 31 + 99, "cpu")
    d.setup()
    d.window(0.0)
    return d, mix, d.sample()


def _fault_unchanged(d, c):
    R0, t0 = d.R0.cpu(), d.t0.cpu()
    c["R"] = R0[:, None].expand_as(c["R"]).clone()
    c["t"] = t0[:, None].expand_as(c["t"]).clone()


def _fault_half_batch(d, c):
    half = d.B // 2
    for k in c:  # the second half's answers are the first half's
        c[k][half:] = c[k][:half]


def _fault_count(d, c):
    c["n_matches"] += 1


def _fault_pose(d, c):
    c["t"][..., 0] += 1e-2


def _fault_minority(d, c):
    """One stream in eight answers a pose 5 cm off: the medians and the
    counts stay, the tail does not."""
    c["t"][d.B // 2, :, 0] += 5e-2


@pytest.mark.parametrize("fault", [None, _fault_unchanged, _fault_half_batch, _fault_count,
                                   _fault_pose, _fault_minority])
def test_localization_correct_only_when_sound(loc, fault):
    d, mix, idx = loc
    answers = [{k: v.clone() for k, v in c.items()} for c in d.calls]
    if fault is not None:
        for c in answers:
            fault(d, c)
    nums = d.judged(answers, idx)
    assert judge(nums, mix["limits"], 0) is (fault is None), nums


def test_localization_failed_answer_is_not_correct(loc):
    d, mix, idx = loc
    assert not judge(d.judged(d.calls, idx), mix["limits"], 1)


@pytest.fixture(scope="module")
def ba():
    s, mix = small_ba()
    d = GlobalBA(s, mix, 2 ** 31 + 5, "cpu")
    d.setup()
    d.window(0.0)
    return d, mix, d.reference()


def _ba_unchanged(d, r):
    return r._replace(kf_R=d.start[0], kf_t=d.start[1], pts=d.start[2], cost=r.cost0)


def _ba_half(d, r):
    half = d.obs_valid.clone()
    half[1::2] = False
    return d.solve(*d.start, *d.obs, d.w, half, d.fixed, d.pt_valid, d.K, iterations=d.iters,
                   max_free_cams=None, early_stop_rel=d.early)


def _ba_point(d, r):
    return r._replace(pts=r.pts + torch.tensor([0.2, 0.0, 0.0]))


@pytest.mark.parametrize("fault", [None, _ba_unchanged, _ba_half, _ba_point])
def test_global_ba_correct_only_when_sound(ba, fault):
    d, mix, ref = ba
    answers = [r if fault is None else fault(d, r) for r in d.results]
    nums = d.compare(answers, ref)
    assert judge(nums, mix["limits"], 0) is (fault is None), nums
