"""No module a run imports, nor the reference, is JAX, jaxlib, flax,
optax or the JAX package, compared by whole top-level names (the port's
name begins with the JAX package's); and the reference imports nothing of
the port."""

import ast
import json
import os
import subprocess
import sys

from tiny_cells import ROOT
from aimbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "adapt_image_models_tpu"}
PROBE = """
import json, sys, time
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from tiny_cells import tiny
from aimbench import run
for w in ("aim-b16-8f.train-b32", "aim-b16-8f.eval3v-b32"):
    run.measure(tiny(w), 5, 0.1, False, device="cpu", t_start=time.perf_counter())
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_the_forbidden_names_are_the_runs():
    assert set(run.FORBIDDEN) == FORBIDDEN


def test_a_run_imports_no_jax():
    tests = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-c", PROBE.format(root=ROOT, tests=tests)],
                          capture_output=True, text=True, timeout=300, check=True)
    names = set(json.loads(proc.stdout.strip().splitlines()[-1]))
    assert "adapt_image_models_torch" in names and "aimbench" in names
    assert not names & FORBIDDEN


def test_forbidden_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "adapt_image_models_tpux", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "adapt_image_models_tpu.ops", sys)
    assert run.forbidden_modules() == ["adapt_image_models_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_the_reference_imports_nothing_of_the_port():
    folder = os.path.join(ROOT, "aimbench", "reference")
    for name in os.listdir(folder):
        if name.endswith(".py"):
            found = set(_imports(os.path.join(folder, name)))
            assert not found & (FORBIDDEN | {"adapt_image_models_torch", "aimbench"}), name
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); import aimbench.reference.aim; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, timeout=120).stdout
    assert "adapt_image_models_torch" not in out and not any(f"'{f}'" in out for f in FORBIDDEN)
