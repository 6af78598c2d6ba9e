"""The control comes out not correct: the reference computed with float8
e4m3 products, put in the program's place, reads well above the program
on one of a cell's numbers at least, and so does each fault that can be
planted in a cell of that kind (``aimbench/calibrate.py``). On the CPU at
the tiny size; on the card (marked ``cuda``) at the cell's own size,
against the committed limits:

    python -m pytest aimbench/tests -m cuda -q

Limits follow from readings kept in files, as ``calibrate.py --readings``
summarizes them.
"""

import json

import pytest
import torch

from tiny_cells import tiny
from aimbench import calibrate, check, spec

CELLS = [w["name"] for w in spec.load_benchmark()["workloads"]]


def _by_what(rows):
    out = {}
    for r in rows:
        out.setdefault(r["what"], []).append(
            {k: v for k, v in r.items() if k not in calibrate.NOT_NUMBERS})
    return out


@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_separate_at_the_tiny_size(workload):
    rows = []
    calibrate.readings(tiny(workload), [2 ** 36 + 1], [2 ** 36 + 2], device="cpu",
                       emit=rows.append)
    got = _by_what(rows)
    prog = got.pop("program")[0]
    assert set(got) >= {"control fp8"}
    for what, readings in got.items():
        assert any(readings[0][k] >= 3 * prog[k] for k in prog), (what, readings, prog)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from adapt_image_models_torch.ops import _kernels
    _kernels.library()
    return torch.cuda.get_device_name(0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", CELLS)
def test_control_and_faults_fail_the_limits_on_the_card(card, workload):
    cell = spec.resolve(workload)
    rows = []
    calibrate.readings(cell, [2 ** 37 + 5], [2 ** 37 + 6], emit=rows.append)
    got = _by_what(rows)
    prog = got.pop("program")[0]
    assert check.verdict(prog, cell["limits"])[0], prog
    for what, readings in got.items():
        assert not check.verdict(readings[0], cell["limits"])[0], (what, readings)


def test_limits_from_earlier_readings(tmp_path, capsys):
    w = "aim-b16-8f.eval3v-b32"
    lines = [{"workload": w, "seed": 1, "what": "program", "prob_l1": 2e-3},
             {"workload": w, "seed": 9, "correct": True, "compared": {"prob_l1": {"value": 3e-3}}},
             {"workload": w, "seed": 2, "what": "control fp8", "prob_l1": 3e-2},
             {"workload": w, "seed": 2, "what": "fault view left out", "prob_l1": 2e-2},
             {"workload": "another", "seed": 3, "what": "program", "prob_l1": 1.0}]
    path = tmp_path / "readings.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in lines))
    assert calibrate.main(["--workload", w, "--readings", str(path)]) == 0
    summary = json.loads(capsys.readouterr().out.splitlines()[-1])["summary"]["prob_l1"]
    assert (summary["lower"], summary["upper"]) == (3e-3, 3e-2)
    assert summary["limit"] == pytest.approx(check.limit_from(3e-3, 3e-2))
