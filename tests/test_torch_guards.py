"""Guards of the PyTorch port: it never imports JAX, and chip_smoke.py
refuses to run without a GPU."""

import os
import subprocess
import sys

import jax  # noqa: F401  (the suite's conftest imports it too)
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a CPU forward of a toy fused-mode model through the port's public API;
# tests/conftest.py imports jax, so this must run in a fresh interpreter
NO_JAX_SCRIPT = r"""
import sys
import torch
from adapt_image_models_torch.apis import init_recognizer
import adapt_image_models_torch.convert, adapt_image_models_torch.ops, adapt_image_models_torch.data.transforms
cfg = dict(model=dict(type="Recognizer3D",
    backbone=dict(type="AIM", input_resolution=32, patch_size=16, width=128,
                  layers=1, heads=2, num_frames=4, compute_dtype="bfloat16",
                  attention_core="fused"),
    cls_head=dict(type="I3DHead", num_classes=3, in_channels=128)))
model = init_recognizer(cfg, device="cpu")
with torch.no_grad():
    out = model.forward_test(torch.zeros(1, 2, 3, 4, 32, 32))
assert out.shape == (1, 3)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax"))
print("JAX_MODULES", bad)
"""


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "JAX_MODULES []" in proc.stdout, proc.stdout


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs there instead")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

