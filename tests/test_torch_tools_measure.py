"""The port's measurement tools and studies against the JAX package's
scripts, on the CPU.

- ``tools/ba_bench.py``: the problem of every shape equals
  ``scripts/ba_bench.py``'s draw for draw, and its dump for
  ``native/ba_anchor.cpp`` byte for byte; a timed run at ``local20``
  reaches JAX's ``bundle_adjust`` cost (scatter form, 10 iterations)
  within ``tests/test_torch_map_ba.py``'s bounds (cost0 1e-5, cost 1e-4
  relative);
- ``tools/scaling_efficiency.py`` at N = 1 and 2 gloo CPU ranks with 512
  points and 2 frames: every record's fields, the final costs equal
  across N within the sharded-BA tests' 1e-3, and the all-reduce payload
  counted from the solve equal to the formula and to JAX's count
  (``SCALING_r05.json``);
- the two studies at their smallest size against the JAX scripts' output.

The ranks import this file, so JAX is imported inside the tests only.
"""

import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch

from orb_slam_tracking_tpu_torch.tools import (ba_bench, bow_match_experiment, scaling_efficiency,
                                               vocab_recall_study)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", sorted(ba_bench.SHAPES))
def test_ba_bench_problem_and_dump_equal_jax(shape, tmp_path):
    jx = _script("ba_bench")
    got, ref = ba_bench.make_problem(0, shape), jx.make_problem(0, shape)
    assert set(got) == set(ref)
    for k in ref:
        assert got[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(got[k], ref[k], k)
    ba_bench.dump(tmp_path / "port.bin", got)
    jx.dump(tmp_path / "jax.bin", ref)
    assert (tmp_path / "port.bin").read_bytes() == (tmp_path / "jax.bin").read_bytes()


def test_ba_bench_run_reaches_jax_cost():
    import jax
    import jax.numpy as jnp

    from orb_slam_tracking_tpu.optim.ba import bundle_adjust as jx_bundle_adjust

    p = ba_bench.make_problem(0, "local20")
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 4))
    try:
        rec = ba_bench.run(p, "local20", "cpu", trials=1, repeats_a=1, repeats_b=2)
    finally:
        torch.set_num_threads(n)
    assert rec["metric"] == "ba_local20_20kf_5120pt_lm_iters_per_s" and rec["device"] == "cpu"
    assert rec["unit"] == "LM iters/s" and rec["shape"] == [20, 5120, 20480]
    # a loaded CPU can time 2 solves no longer than 1: that trial has no
    # estimate and is counted as invalid
    valid = rec["ms_per_10iter_solve_trials"]
    assert len(valid) + rec["invalid_trials"] == 1
    if valid:
        assert rec["value"] == ba_bench.ITERS / (valid[0] / 1e3) > 0 and rec["spread"] == 0.0
    else:
        assert rec["value"] is None and rec["spread"] is None
    O = len(p["obs_kf"])
    K = np.array([[ba_bench.FX, 0, ba_bench.CX], [0, ba_bench.FY, ba_bench.CY], [0, 0, 1]],
                 np.float32)
    solve = jax.jit(lambda R, t, X: jx_bundle_adjust(
        R, t, X, jnp.asarray(p["obs_kf"]), jnp.asarray(p["obs_pt"]),
        jnp.asarray(p["obs_uv"].astype(np.float32)), jnp.ones(O, jnp.float32),
        jnp.ones(O, bool), jnp.asarray(p["kf_fixed"]), jnp.ones(len(p["pts0"]), bool),
        jnp.asarray(K), iterations=ba_bench.ITERS, max_free_cams=None, segment_mode="scatter"))
    ref = solve(*(jnp.asarray(p[k].astype(np.float32)) for k in ("kf_R0", "kf_t0", "pts0")))
    assert rec["cost0"] == pytest.approx(float(ref.cost0), rel=1e-5)
    assert rec["cost"] == pytest.approx(float(ref.cost), rel=1e-4)
    assert rec["cost"] < 0.01 * rec["cost0"]


@pytest.mark.parametrize("ticks, ms, invalid", [
    # warm-up, then per trial t(1 solve) and t(2 solves) as (start, end) pairs
    ((0, 1, 10, 15, 20, 23, 30, 31, 40, 43), [2000.0], 1),
    ((0, 1, 10, 15, 20, 23), [], 1),
])
def test_ba_bench_leaves_out_a_trial_without_estimate(monkeypatch, ticks, ms, invalid):
    """A trial whose two-point difference is not positive is counted in
    ``invalid_trials`` and kept out of the times; with none left the
    record's times are None."""
    clock = iter(ticks)
    monkeypatch.setattr(ba_bench, "time", types.SimpleNamespace(perf_counter=lambda: next(clock)))
    monkeypatch.setattr(ba_bench, "bundle_adjust", lambda R, t, X, **kw: types.SimpleNamespace(
        kf_R=R, kf_t=t, pts=X, cost0=torch.tensor(2.0), cost=torch.tensor(1.0)))
    rec = ba_bench.run(ba_bench.make_problem(0, "local20"), "local20", "cpu",
                       trials=(len(ticks) - 2) // 4, repeats_a=1, repeats_b=2)
    assert rec["ms_per_10iter_solve_trials"] == ms and rec["invalid_trials"] == invalid
    if ms:
        assert rec["value"] == ba_bench.ITERS / 2.0 and rec["spread"] == 0.0
    else:
        assert rec["value"] is None and rec["ms_per_10iter_solve"] is None
    assert (rec["cost0"], rec["cost"]) == (2.0, 1.0)


def test_scaling_plan():
    """Which ranks run where: NCCL one rank a card up to the card count,
    gloo ranks sharing the cards only when asked, else not run."""
    assert scaling_efficiency.plan(1, False, 1, False)["backend"] == "nccl"
    assert scaling_efficiency.plan(4, False, 1, False) == {
        "backend": None, "cards": 1, "ranks_per_card": None, "not_run": "1 card"}
    shared = scaling_efficiency.plan(8, False, 2, True)
    assert shared["backend"] == "gloo" and shared["ranks_per_card"] == 4 and shared["shared_card"]
    assert scaling_efficiency.plan(2, True, 0, False)["device"] == "cpu"


def test_scaling_efficiency_on_cpu_ranks():
    rec = scaling_efficiency.measure([1, 2], cpu=True, n_points=512, frames=2, reps=1,
                                     say=lambda *a: None)
    with open(os.path.join(REPO, "SCALING_r05.json")) as f:
        jax_payload = json.load(f)["psum_payload_bytes"]
    assert rec["psum_payload_bytes"] == rec["psum_payload_bytes_formula"] == jax_payload == 61448
    assert rec["device"] == "cpu"
    ba = {r["n"]: r for r in rec["results"] if r["bench"] == "ba_strong"}
    ms = {r["n"]: r for r in rec["results"] if r["bench"] == "multiseq_weak"}
    assert set(ba) == set(ms) == {1, 2}
    for n in (1, 2):
        for r in (ba[n], ms[n]):
            assert r["backend"] == "gloo" and r["cards"] == 0 and r["ranks_per_card"] is None
        assert ba[n]["points"] == 512 and ba[n]["psum_payload_bytes"] == 61448
        assert ba[n]["allreduce_calls_per_iter"] == 2 and ba[n]["collective_ms_per_iter"] > 0
        assert ba[n]["ms_per_solve"] > 0 and ba[n]["iters_per_s"] > 0
        assert len(set(ba[n]["final_cost_by_rank"])) == 1
        assert ms[n]["frames"] == 2 and ms[n]["aggregate_fps"] > 0
    assert ba[2]["final_cost"] == pytest.approx(ba[1]["final_cost"], rel=1e-3)


def test_bow_match_experiment_matches_jax(monkeypatch, capsys):
    """The three pairs' keypoint counts equal, the match counts within 1 %
    + 1 of the JAX script's (the extractions' f32 order differs, so a
    borderline keypoint of the noisy frames can fall the other way)."""
    got = bow_match_experiment.run(device="cpu", say=lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["bow_match_experiment.py"])
    _script("bow_match_experiment").main()
    lines = [ln for ln in capsys.readouterr().out.splitlines() if "searchbybow=" in ln]
    assert len(lines) == len(got) == 3
    for rec, line in zip(got, lines):
        name, rest = line.split(": kps ")
        kps, glob, bow = rest.split()
        assert name == rec["pair"] and [int(x) for x in kps.split("/")] == rec["kps"]
        for key, field in (("global", glob), ("searchbybow", bow)):
            ref = int(field.split("=")[1])
            assert abs(rec[key] - ref) <= 0.01 * ref + 1, (name, key, rec[key], ref)


def test_vocab_recall_study_matches_jax(monkeypatch, capsys, tmp_path):
    """Two worlds under the 10k-word vocabulary: the JAX script's recall,
    threshold (to its 4 printed decimals) and margin, and the same DBoW2
    text round trip."""
    voc = str(vocab_recall_study.VOCABULARIES[0])
    got = vocab_recall_study.run(2, [voc], "cpu", say=lambda *a: None)
    monkeypatch.setattr(sys, "argv", ["vocab_recall_study.py", "--worlds", "2", "--vocabs", voc])
    _script("vocab_recall_study").main()
    ref = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.startswith("{")]
    assert len(ref) == len(got) == 2
    for k in ("vocab", "n_words", "recall_at_1", "recall_at_tau", "worlds"):
        assert got[0][k] == ref[0][k], k
    for k in ("tau_reject95_distractors", "mean_top1_top2_margin"):
        assert abs(got[0][k] - ref[0][k]) <= 5e-5 + 1e-6, k
    assert got[1] == ref[1] == {"orbvoc_text_roundtrip": True, "vocab": os.path.basename(voc),
                                "text_bytes": ref[1]["text_bytes"]}
