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
# train_model over synthetic videos, a checkpointed train-mode backward of a
# toy ViT_CLIP under the flash core, and the long-clip path of
# tests/test_torch_longclip.py (LONG_CLIP_T lowered to 4): a train step of a
# toy AIM at 6 frames and the LN temporal block, frozen and not; and the
# LN-only and adapter-only calls of tests/test_torch_attention_blocks.py
# (the LN block over tokens, frozen and not, the adapter block over tokens
# and over frames), forward and backward;
# tests/conftest.py imports jax, so this must run in a fresh interpreter
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
vc = dict(cfg["model"], backbone=dict(type="ViT_CLIP", input_resolution=32, patch_size=16,
                                     width=128, layers=1, heads=2, num_frames=4,
                                     attention_core="flash", use_checkpoint=True))
vc_model = init_recognizer(dict(cfg, model=vc), device="cpu")
vc_model.train()
vc_model(torch.zeros(2, 3, 4, 32, 32)).sum().backward()
state, history = train_model(cfg, work_dir=os.path.join(tmp, "work"), validate=False,
                             device="cpu")
assert state.step == 1 and history, history
import adapt_image_models_torch.ops.fused_temporal_attention as fta
from adapt_image_models_torch.models.layers import CLIPAttention, LayerNormFP32
fta.LONG_CLIP_T = 4
long_cfg = dict(cfg["model"], backbone=dict(cfg["model"]["backbone"], num_frames=6,
                                           num_tadapter=1, compute_dtype="float32"))
long_model = init_recognizer(dict(cfg, model=long_cfg), device="cpu")
from adapt_image_models_torch.parallel import freeze_params
freeze_params(long_model)
long_model.train()
long_model(torch.zeros(2, 3, 6, 32, 32)).sum().backward()
for frozen in (False, True):
    attn = CLIPAttention(128, 2, torch.bfloat16, "fused", frozen_backward=frozen)
    attn.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(12, 5, 128).to(torch.bfloat16).requires_grad_()
    attn(x, temporal_frames=6, ln=LayerNormFP32(128)).float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
from adapt_image_models_torch.models.layers import Adapter
for frozen, kwargs in ((False, dict(ln=LayerNormFP32(128))), (True, dict(ln=LayerNormFP32(128))),
                       (False, dict(adapter=Adapter(128))),
                       (False, dict(temporal_frames=6, adapter=Adapter(128)))):
    attn = CLIPAttention(128, 2, torch.bfloat16, "fused", frozen_backward=frozen)
    attn.init_weights(torch.Generator().manual_seed(1))
    x = torch.randn(12, 5, 128).to(torch.bfloat16).requires_grad_()
    attn(x, **kwargs).float().sum().backward()
    assert torch.isfinite(x.grad.float()).all()
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
    chip_smoke.py, the port's tools or the test files that also run on the
    card's host, which has no JAX (``--noconftest``); comments and
    docstrings that cite JAX file paths are not imports."""
    files = (glob.glob(os.path.join(ROOT, "adapt_image_models_torch", "**", "*.py"),
                       recursive=True)
             + [os.path.join(ROOT, "chip_smoke.py")]
             + glob.glob(os.path.join(ROOT, "tools", "*_torch.py"))
             + [os.path.join(ROOT, "tests", name)
                for name in ("test_torch_cuda.py", "test_torch_gemm_design.py",
                             "test_torch_temporal_bwd.py", "test_torch_temporal_fwd.py")])
    assert len(files) > 30
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"adapt_image_models_torch/models/backbones/vit_clip.py",
            "adapt_image_models_torch/ops/flash_attention.py"} <= names
    bad = {os.path.relpath(f, ROOT): sorted(set(_imported_roots(f)) & set(FORBIDDEN))
           for f in files}
    assert not {f: b for f, b in bad.items() if b}


def test_entry_points_default_to_the_card():
    """Every entry point runs on the GPU unless the caller asks for the CPU:
    the ``device`` default of the API functions and of both CLIs."""
    import inspect
    from adapt_image_models_torch import apis
    for fn in (apis.init_recognizer, apis.run_evaluation, apis.train_model):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    for tool in ("test_torch.py", "train_torch.py"):
        src = open(os.path.join(ROOT, "tools", tool)).read()
        assert 'add_argument("--device", default="cuda"' in src, tool


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs there instead")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
