"""Cells found from files by name, and the import check."""

import json
import subprocess
import sys

import pytest

from slambench import cells
from slambench.cells import BENCH, ROOT, find_cell, forbidden_modules, metric_reader
from slambench.run import mix_class

BENCHMARK = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in BENCHMARK["workloads"]])
def test_cell_found_from_files(workload):
    c = find_cell(workload)
    assert c.name == workload and c.chips in (1, 4)
    conf = {x["name"]: x for x in BENCHMARK["configs"]}[c.config]
    assert c.settings["Bench.source"] == conf["source"]
    assert c.settings["Bench.reduced"] == conf["reduced"]
    assert set(conf["reduced"]) <= set(c.settings)
    assert all(k in c.settings for k in c.settings["Bench.assumed"])
    assert (BENCH / "traffic" / f"{c.traffic}.json").is_file()
    assert mix_class(c.mix["generator"]).__module__ == f"slambench.mixes.{c.mix['generator']}"
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"} and len(c.end_to_end) >= 2
    assert c.per_layer
    for m in c.per_layer:
        # a reader that finds nothing returns nothing
        assert metric_reader(m["name"])({"kind": "none", "kernels": {}, "work": {}}) is None
    assert c.mix["limits"]


def test_every_metric_has_a_reader_and_a_moved_metric():
    e2e = {m["name"] for m in BENCHMARK["end_to_end"]}
    for m in BENCHMARK["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        find_cell("no-such.cell")


def test_forbidden_compares_whole_top_level_names():
    mods = ["orb_slam_tracking_tpu_torch", "orb_slam_tracking_tpu_torch.ops", "jaxtyping",
            "numpy", "jax.numpy", "orb_slam_tracking_tpu.ops", "flax", "jaxlib"]
    assert forbidden_modules(mods) == ["flax", "jax.numpy", "jaxlib", "orb_slam_tracking_tpu.ops"]
    assert cells.FORBIDDEN == ("jax", "jaxlib", "flax", "orb_slam_tracking_tpu")


def test_harness_and_program_load_no_jax():
    """In a fresh process: the harness, its generators and reference, and the
    program modules a run drives load nothing forbidden."""
    code = (
        "import sys\n"
        "import slambench.run, slambench.sweep, slambench.limits\n"
        "import slambench.mixes.localization, slambench.mixes.global_ba\n"
        "import orb_slam_tracking_tpu_torch.parallel.multiseq, orb_slam_tracking_tpu_torch.optim.ba\n"
        "import orb_slam_tracking_tpu_torch.utils.profiling\n"
        "from slambench.cells import forbidden_modules\n"
        "print(forbidden_modules(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_reference_imports_nothing_of_the_program():
    code = (
        "import sys\n"
        "import slambench.reference.orb, slambench.reference.track, slambench.reference.ba\n"
        "import slambench.reference.render_numpy, slambench.scene, slambench.peaks\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0].startswith("
        "('orb_slam_tracking_tpu', 'jax', 'flax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip() == "[]"


def test_run_refuses_without_a_card(monkeypatch):
    """Here, with no CUDA device: exit 3 and no result."""
    out = subprocess.run([sys.executable, "-m", "slambench.run", "--workload",
                          BENCHMARK["workloads"][0]["name"], "--seed", str(2 ** 31 + 7),
                          "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**__import__("os").environ, "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode == 3 and out.stdout == ""
