"""The yardstick's roofline functions against ``chip_smoke.py``'s bounds at
the port's kernel table's shapes."""

import importlib.util

import pytest

from slambench import peaks
from slambench.cells import ROOT
from slambench.reference.orb import Extractor, OrbParams


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_bounds", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_peaks_are_chip_smokes():
    cs = _chip_smoke()
    assert (peaks.HBM_BYTES_PER_S, peaks.F32_OPS_PER_S, peaks.B1_MMA_OPS_PER_S) == (
        cs.HBM_BYTES_PER_S, cs.F32_OPS_PER_S, cs.B1_MMA_OPS_PER_S)


def test_fast_score_bound_at_the_entry_canvas():
    cs = _chip_smoke()
    e = Extractor(480, 640, OrbParams(1000, 1.2, 8, 20, 7), "cpu")
    n_out = (e.canvas_h - 38) * (e.canvas_w - 38)
    want_ms, _ = cs.bound_ms(4.0 * (e.canvas_h * e.canvas_w + n_out), 175.0 * n_out)
    got = peaks.bound_s(*peaks.fast_score_work(1, e.canvas_h, e.canvas_w))
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert round(got * 1e3, 4) == 0.0047  # PERF.md's kernel table, B1
    # a batch scales the work, not the share
    assert peaks.bound_s(*peaks.fast_score_work(8, e.canvas_h, e.canvas_w)) == pytest.approx(
        8 * got, rel=1e-12)


@pytest.mark.parametrize("P,N,table_ms", [(8192, 1024, 0.0013), (2048, 2048, 0.0006),
                                          (2048, 1024, 0.0003)])
def test_hamming_gated_min_bound_at_the_table_shapes(P, N, table_ms):
    cs = _chip_smoke()
    want_ms, _ = cs.bound_ms(32.0 * (P + N) + 34.0 * P + 17.0 * N, 10.0 * P * N, 512.0 * P * N)
    got = peaks.bound_s(*peaks.hamming_gated_min_work(1, P, N))
    assert got * 1e3 == pytest.approx(want_ms, rel=1e-12)
    assert round(got * 1e3, 4) == table_ms


def test_orient_describe_counts_distinct_pixels():
    import torch

    from slambench.reference.orb import umax_table

    umax = umax_table()
    one = torch.tensor([[100, 100]])
    far = torch.tensor([[100, 100], [100, 300]])
    same = torch.tensor([[100, 100], [100, 100]])
    samples = torch.zeros((2, 512, 2), dtype=torch.int64)
    b1, o1 = peaks.orient_describe_work((500, 500), one, samples[:1], umax)
    b2, o2 = peaks.orient_describe_work((500, 500), far, samples, umax)
    b3, _ = peaks.orient_describe_work((500, 500), same, samples, umax)
    disc = sum(2 * umax[abs(dy)] + 1 for dy in range(-15, 16))
    assert b1 == 4.0 * (disc + 1 + 4 + 1024 + 9)
    assert b2 - b1 == 4.0 * (disc + 13) and o2 == 2 * o1
    assert b3 - b1 == 4.0 * 13  # the second keypoint reads nothing new
