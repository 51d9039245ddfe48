"""Finding a cell and its parts by name.

``BENCHMARK.json`` at the root of the checkout names each cell's
configuration and traffic mix. A configuration is
``slambench/configs/<name>.yaml``: ORB-SLAM2 settings in the upstream
project's flat ``key: value`` form (OpenCV FileStorage YAML), with the
deployment the benchmark assumes under ``Bench.`` keys. A traffic mix is
``slambench/traffic/<name>.json``, whose ``generator`` names the general
generator in ``slambench/mixes/`` that reads it. A per-layer metric is
``slambench/metrics/<name>.py`` with a ``read(readings)`` function.
"""

from __future__ import annotations

import ast
import importlib.util
import json
from pathlib import Path
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = ["ROOT", "BENCH", "Cell", "find_cell", "load_settings", "load_traffic",
           "metric_reader", "forbidden_modules", "FORBIDDEN"]

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# the JAX reference package and JAX itself: never loaded by a run
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam_tracking_tpu")


class Cell(NamedTuple):
    name: str
    config: str
    traffic: str
    chips: int
    settings: Dict[str, Any]
    mix: Dict[str, Any]
    end_to_end: List[dict]   # the cell's end-to-end metrics
    per_layer: List[dict]    # the cell's per-layer metrics


def _value(text: str) -> Any:
    text = text.strip()
    if not text:
        return None
    if text[0] in "\"'[":
        return ast.literal_eval(text)
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def load_settings(path: Path) -> Dict[str, Any]:
    """A flat ORB-SLAM2 settings file: ``%YAML`` headers, ``---`` and ``#``
    comments skipped, every other line ``key: value`` with a number, a
    quoted string, a ``[...]`` list or a bare word."""
    out: Dict[str, Any] = {}
    for n, line in enumerate(path.read_text().splitlines(), 1):
        s = line.strip()
        if not s or s.startswith(("#", "%", "---")):
            continue
        key, sep, rest = s.partition(":")
        if not sep or " " in key:
            raise ValueError(f"{path}:{n}: not a 'key: value' line: {line!r}")
        out[key] = _value(rest)
    return out


def load_traffic(name: str) -> Dict[str, Any]:
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def find_cell(workload: str, bench_file: Optional[Path] = None) -> Cell:
    """The cell ``workload`` of ``BENCHMARK.json`` with its configuration's
    settings, its traffic mix and the metrics it reports."""
    bench = json.loads((bench_file or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    settings = load_settings(ROOT / configs[w["config"]]["file"])
    return Cell(workload, w["config"], w["traffic"], int(w["chips"]), settings,
                load_traffic(w["traffic"]),
                [m for m in bench["end_to_end"] if _applies(m, workload)],
                [m for m in bench["per_layer"] if _applies(m, workload)])


def metric_reader(name: str) -> Callable[[Dict[str, Any]], Optional[float]]:
    """``read`` of ``slambench/metrics/<name>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"slambench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules(modules) -> List[str]:
    """The loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole: ``orb_slam_tracking_tpu_torch`` is
    not ``orb_slam_tracking_tpu``."""
    return sorted(m for m in modules if m.split(".", 1)[0] in FORBIDDEN)
