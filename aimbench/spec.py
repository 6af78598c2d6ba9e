"""Finds everything of a cell by the names in ``BENCHMARK.json``: its
configuration's file, its traffic mix (``aimbench/traffic/<name>.json``),
the limits its comparison is held to (``aimbench/limits/<cell>.json``) and
a reader for each of its metrics (``aimbench/metrics/<metric>.py``, whose
``read(ctx)`` returns the number or None)."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, Optional

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "aimbench"


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def load_reader(name: str) -> Callable[[dict], Optional[float]]:
    """``read`` of ``aimbench/metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"aimbench_metric_{name.replace('.', '_')}",
                                                  path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(bench: dict, workload: str):
    """(end-to-end, per-layer) metric entries a cell reports: those that
    list it, and those without a list (a per-layer one then wherever the
    end-to-end metric it moves is reported)."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (workload in m["workloads"] if "workloads" in m else m["moves"] in names)]
    return e2e, layer


def resolve(workload: str, bench: Optional[dict] = None) -> Dict:
    """The cell ``workload`` with its configuration, traffic, limits and
    metric readers; KeyError where a name does not resolve."""
    bench = bench or load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json: {sorted(cells)}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e, layer = cell_metrics(bench, workload)
    limits_path = HERE / "limits" / f"{workload}.json"
    return {
        "name": workload, "chips": int(cell["chips"]),
        "config": load_json(ROOT / entry["file"]),
        "traffic": load_json(HERE / "traffic" / f"{cell['traffic']}.json"),
        "limits": load_json(limits_path) if limits_path.exists() else {},
        "end_to_end": e2e, "per_layer": layer,
        "readers": {m["name"]: load_reader(m["name"]) for m in e2e + layer},
    }
