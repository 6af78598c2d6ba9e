"""BENCHMARK.json against the benchmark's contract: its keys, names, units
and lengths, and that every name a cell uses resolves to a file of its
own under ``paths``."""

import json
import os
import re

import pytest

from tiny_cells import ROOT
from aimbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_text(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    named = [w for w in BENCH["command"] if "/" in w]
    assert all(any(w.startswith(p + "/") for p in BENCH["paths"]) for w in named)
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_every_name_and_unit_keeps_to_its_characters():
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
             + [w[k] for w in BENCH["workloads"] for k in ("config", "traffic")]
             + [k for c in BENCH["configs"] for k in c["reduced"]])
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    for group in ("configs", "workloads"):
        assert len({x["name"] for x in BENCH[group]}) == len(BENCH[group])
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"]) and len(c["reduced"]) <= 16
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _text(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert {w["config"] for w in BENCH["workloads"]} == {c["name"] for c in BENCH["configs"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e and _text(m["layer"])
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_files_resolve_by_name(workload):
    cell = spec.resolve(workload)
    e2e = {m["name"] for m in cell["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2 and cell["per_layer"]
    for m in cell["per_layer"]:  # every per-layer metric moves one the cell reports
        assert m["moves"] in e2e
    assert set(cell["readers"]) == e2e | {m["name"] for m in cell["per_layer"]}
    assert cell["traffic"]["kind"] in ("train", "eval")
    assert cell["limits"], f"aimbench/limits/{workload}.json holds no limit"
    entry = next(c for c in BENCH["configs"] if c["name"] == cell["config"]["name"])
    assert entry["file"] == f"aimbench/configs/{entry['name']}.json"
    assert entry["reduced"] == cell["config"]["reduced"]


@pytest.mark.parametrize("workload", CELLS)
def test_readers_return_nothing_without_a_reading(workload):
    cell = spec.resolve(workload)
    other = {"train": "eval", "eval": "train"}[cell["traffic"]["kind"]]
    ctx = {"kind": other, "setup_s": 1.0, "peak_bytes": 0, "flops_per_unit": 1.0,
           "peak_flops": 1.0, "timeline": None, "rooflines": None,
           "dispatch_ms": None, "window": {"seconds": 1.0, "calls": 0, "units": 0, "call_ms": []}}
    for m in cell["per_layer"]:
        assert cell["readers"][m["name"]](ctx) is None, m["name"]


def test_paths_hold_the_benchmark_alone():
    for p in BENCH["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    for c in BENCH["configs"]:
        assert any(c["file"].startswith(p + "/") for p in BENCH["paths"])
