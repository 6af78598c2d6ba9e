"""A run of ``aimbench/run.py`` without the card: its ``measure`` at the
tiny size on the CPU (the chip's look skipped) gives a result line of the
contract's form; ``main`` without a card, and a checkout that holds only
``BENCHMARK.json`` and the benchmark, print no result and exit non-zero."""

import json
import os
import shutil
import subprocess
import sys
import time

import pytest

from tiny_cells import ROOT, tiny
from aimbench import run, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]
LOOSE = {"loss_gap": 0.05, "grad_gap": 0.05, "change_gap": 0.2, "prob_l1": 0.02}


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_dry_run_gives_a_result_line(workload):
    cell = tiny(workload, limits=LOOSE)
    result, shown = run.measure(cell, 2 ** 40 + 9, 0.3, False, device="cpu",
                                t_start=time.perf_counter())
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "compared" and result["compared"] == shown
    assert result["correct"] is True and result["attempted"] > 0 and result["failed"] == 0
    kind = cell["traffic"]["kind"]
    rate = "train_clips_per_s" if kind == "train" else "eval_videos_per_s"
    assert set(result["metrics"]) == {"setup_s", rate}  # no device reading on the CPU
    assert result["device"]["platform"] == "cpu"
    json.dumps(result)


def test_main_without_a_card_prints_no_result(capsys):
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", CELLS[0], "--seed", "1", "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "CUDA device" in out.err


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "aimbench"), tmp_path / "aimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "aimbench/run.py", "--workload", CELLS[0], "--seed",
                           "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0 and proc.stdout.strip() == ""
