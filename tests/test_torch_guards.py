"""Guards of the PyTorch port: it never imports JAX or the JAX package, and
chip_smoke.py refuses to run without a GPU."""

import ast
import glob
import os
import subprocess
import sys

import jax  # noqa: F401  (the suite's conftest imports it too)
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "adapt_image_models_tpu")

# the port's entry points on a toy fused-mode num_tadapter=2 model with
# LabelSmoothing, on the CPU: init_recognizer, a forward, run_evaluation and
# train_model over synthetic videos; tests/conftest.py imports jax, so this
# must run in a fresh interpreter
NO_JAX_SCRIPT = r"""
import os, sys, tempfile
import torch
from adapt_image_models_torch.apis import init_recognizer, run_evaluation, train_model
import adapt_image_models_torch.convert, adapt_image_models_torch.ops, adapt_image_models_torch.data.transforms
tmp = tempfile.mkdtemp()
ann = os.path.join(tmp, "ann.txt")
with open(ann, "w") as f:
    f.write("synthetic://0 0\nsynthetic://1 2\n")
pipe = [dict(type="SampleFrames", clip_len=4, frame_interval=2, num_clips=1),
        dict(type="Resize", scale=(-1, 32)), dict(type="CenterCrop", crop_size=32),
        dict(type="Normalize"), dict(type="FormatShape", input_format="NCTHW")]
cfg = dict(
    model=dict(type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=32, patch_size=16, width=128,
                      layers=1, heads=2, num_frames=4, compute_dtype="bfloat16",
                      attention_core="fused", num_tadapter=2),
        cls_head=dict(type="I3DHead", num_classes=3, in_channels=128),
        train_cfg=dict(blending=dict(type="LabelSmoothing", num_classes=3,
                                     smoothing=0.1))),
    data=dict(videos_per_gpu=2, workers_per_gpu=1,
              train=dict(type="VideoDataset", ann_file=ann, pipeline=pipe),
              test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe)),
    optimizer=dict(type="AdamW", lr=1e-3, weight_decay=0.05),
    total_epochs=1, log_config=dict(interval=1))
model = init_recognizer(cfg, device="cpu")
with torch.no_grad():
    out = model.forward_test(torch.zeros(1, 2, 3, 4, 32, 32))
assert out.shape == (1, 3)
results = run_evaluation(cfg, model=model, num_workers=1)
assert "top1_acc" in results, results
state, history = train_model(cfg, work_dir=os.path.join(tmp, "work"), validate=False,
                             device="cpu")
assert state.step == 1 and history, history
bad = sorted(m for m in sys.modules if m.split(".")[0] in %r)
print("FORBIDDEN_MODULES", bad)
""" % (FORBIDDEN,)


def test_port_never_imports_jax():
    proc = subprocess.run([sys.executable, "-c", NO_JAX_SCRIPT], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "FORBIDDEN_MODULES []" in proc.stdout, proc.stdout


def _imported_roots(path):
    """Top-level package names of every import statement in a file."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_package():
    """No import of jax, flax or the JAX package in the port's modules,
    chip_smoke.py or the port's tools; comments and docstrings that cite
    JAX file paths are not imports."""
    files = (glob.glob(os.path.join(ROOT, "adapt_image_models_torch", "**", "*.py"),
                       recursive=True)
             + [os.path.join(ROOT, "chip_smoke.py")]
             + glob.glob(os.path.join(ROOT, "tools", "*_torch.py")))
    assert len(files) > 30
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs there instead")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
