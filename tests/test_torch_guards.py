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
# and over frames), forward and backward; a train-mode forward and backward
# of a toy Recognizer2D (ResNetTSM with a non-local block and the temporal
# pool), which moves its BatchNorms' running statistics; the same of toy 3D
# CNNs (SlowFast, X3D, CSN with a non-local stage, R(2+1)D, C3D), and precise
# BN over one of them; GradCAM and every tool of the port (tools/**/*_torch.py,
# demo/*_torch.py) on the tiny recipe or files of their own, on the CPU;
# tests/conftest.py imports jax, so this must run in a fresh interpreter
NO_JAX_SCRIPT = r"""
import os, sys, tempfile
import torch
from adapt_image_models_torch.apis import init_recognizer, run_evaluation, train_model
import adapt_image_models_torch.convert, adapt_image_models_torch.ops, adapt_image_models_torch.data.transforms
import adapt_image_models_torch.parallel.distributed, adapt_image_models_torch.utils.env
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
from adapt_image_models_torch.models import build_model
cnn = build_model(dict(type="Recognizer2D",
    backbone=dict(type="ResNetTSM", depth=50, num_frames=4, stage_blocks=(1, 1, 1, 1),
                  base_channels=16, non_local=((0,), (1,), 0, 0), temporal_pool=True),
    cls_head=dict(type="TSMHead", num_classes=3, in_channels=512)))
cnn.init_weights(torch.Generator().manual_seed(0))
cnn.train()
cnn(torch.randn(2, 4, 3, 33, 33)).sum().backward()
assert cnn.backbone.bn1.running_mean.abs().sum() > 0
from adapt_image_models_torch.utils.precise_bn import compute_precise_bn_stats
for bb, head, width, t in (
        (dict(type="ResNet3dSlowFast", alpha=4, base_channels=16, stage_blocks=(1, 1, 1, 1)),
         "SlowFastHead", 576, 8),
        (dict(type="X3D", base_channels=8, stage_blocks=(1, 1, 1, 1)), "X3DHead", 144, 4),
        (dict(type="ResNet3dCSN", depth=50, base_channels=8, stage_blocks=(1, 1, 1, 1),
              bottleneck_mode="ip", non_local=(0, 1, 0, 0)), "I3DHead", 256, 4),
        (dict(type="ResNet2Plus1d", stage_blocks=(1, 1, 1, 1)), "I3DHead", 512, 4),
        (dict(type="C3D", clip_size=(16, 32, 32)), "I3DHead", 4096, 16)):
    net = build_model(dict(type="Recognizer3D", backbone=bb,
                           cls_head=dict(type=head, num_classes=3, in_channels=width)))
    net.init_weights(torch.Generator().manual_seed(0))
    net.train()
    net(torch.randn(2, 3, t, 32, 32), torch.Generator().manual_seed(1)).sum().backward()
compute_precise_bn_stats(cnn, [{"imgs": torch.randn(2, 4, 3, 33, 33)}],
                         prepare_fn=torch.as_tensor)
import adapt_image_models_torch.data.audio  # noqa: F401
for cfg_, x in (
        (dict(type="Recognizer3D",
              backbone=dict(type="ResNet3dSlowOnly", depth=18, base_channels=16,
                            stage_blocks=(1, 1, 1, 1), out_indices=(2, 3)),
              neck=dict(type="TPN", in_channels=(64, 128), out_channels=32, mid_channels=16,
                        fusion_channels=64, downsample_scales=(2, 4), aux_head_classes=3),
              cls_head=dict(type="TPNHead", num_classes=3, in_channels=64)),
         torch.randn(2, 3, 8, 32, 32)),
        (dict(type="Recognizer2D", backbone=dict(type="ResNetTIN", depth=18, num_segments=4),
              cls_head=dict(type="TRNHead", num_classes=3, in_channels=512, num_segments=4)),
         torch.randn(2, 4, 3, 32, 32)),
        (dict(type="AudioRecognizer", backbone=dict(type="ResNetAudio", depth=18,
                                                    base_channels=8),
              cls_head=dict(type="AudioTSNHead", num_classes=3, in_channels=64)),
         torch.randn(2, 2, 1, 32, 16))):
    net = build_model(cfg_)
    net.init_weights(torch.Generator().manual_seed(0))
    net.train()
    net(x, torch.Generator().manual_seed(1)).sum().backward()
import importlib.util, json
def tool(rel):
    spec = importlib.util.spec_from_file_location("tool_" + os.path.basename(rel)[:-3], rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
tiny = "configs/recognition/vit/vitclip_debug_tiny.py"
cpu = ["--device", "cpu"]
from adapt_image_models_torch.utils.gradcam import gradcam
cam, _ = gradcam(model, torch.zeros(1, 3, 4, 32, 32), device="cpu")
assert cam.shape == (1, 4, 32, 32)
assert tool("tools/analysis/get_flops_torch.py").main([tiny, "--device", "meta"])["flops"] > 0
tool("tools/analysis/profile_torch.py").main([tiny, "--out", tmp, "--batch", "1",
                                              "--iters", "1"] + cpu)
pt2 = os.path.join(tmp, "tiny.pt2")
export = tool("tools/deployment/export_torch.py")
export.main([tiny, "--out", pt2] + cpu)
export.main(["--load", pt2] + cpu)
tool("tools/test_torch.py").main([tiny, "--exported", pt2, "--cfg-options",
                                  f"data.test.ann_file={ann}"] + cpu)
bench = tool("tools/analysis/benchmark_torch.py")
for flags in ([], ["--train"], ["--e2e", "--workers", "1"]):
    bench.main([tiny, "--batch", "1", "--iters", "1"] + flags + cpu)
tool("tools/analysis/train_benchmark_torch.py").main([tiny, "--batches", "1", "--iters", "1"]
                                                     + cpu)
tool("tools/misc/clip_feature_extraction_torch.py").main(
    [tiny, os.path.join(tmp, "f.npz"), "--batch", "2", "--workers", "1",
     "--cfg-options", f"data.test.ann_file={ann}"] + cpu)
tool("demo/demo_torch.py").main([tiny, "synthetic://1"] + cpu)
tool("demo/demo_gradcam_torch.py").main([tiny, "synthetic://1", "--out",
                                         os.path.join(tmp, "cam.npz")] + cpu)
tool("demo/long_video_demo_torch.py").main([tiny, "synthetic://1", "--stride-sec", "4"] + cpu)
tool("tools/verify_zoo_torch.py").main(["--param-check-only", "--model", "aim_vitb16_k400_8x3x1"])
tool("tools/analysis/print_config_torch.py").main([tiny])
import numpy as np
np.savez(os.path.join(tmp, "s.npz"), scores=np.eye(2, 10, dtype=np.float32), labels=np.arange(2))
tool("tools/analysis/eval_metric_torch.py").main(
    [tiny, os.path.join(tmp, "s.npz"), "--cfg-options", f"data.test.ann_file={ann}"])
tool("tools/analysis/report_accuracy_torch.py").main(["--scores", os.path.join(tmp, "s.npz")])
gt, det = os.path.join(tmp, "gt.json"), os.path.join(tmp, "det.json")
json.dump({"v_a": {"annotations": [{"segment": [1.0, 3.0], "label": "x"}]}}, open(gt, "w"))
json.dump({"results": {"a": [{"segment": [1.0, 3.0], "label": "x", "score": 1.0}]}},
          open(det, "w"))
tool("tools/analysis/report_map_torch.py").main(["--proposal", det, "--gt", gt,
                                                 "--cls", "label_in_file"])
tem = os.path.join(tmp, "tem")
os.makedirs(tem)
np.savetxt(os.path.join(tem, "v.csv"), np.linspace(0, 1, 60).reshape(12, 5), delimiter=",",
           header="action,start,end,tmin,tmax", comments="")
json.dump({"v": dict(duration_second=4.0, duration_frame=120,
                     annotations=[dict(segment=[1.0, 2.0])])}, open(gt, "w"))
tool("tools/misc/bsn_proposal_generation_torch.py").main(
    [gt, "--tem-results-dir", tem, "--pgm-proposals-dir", os.path.join(tmp, "p"),
     "--pgm-features-dir", os.path.join(tmp, "q")])
import cv2
video = os.path.join(tmp, "cam.avi")
writer = cv2.VideoWriter(video, cv2.VideoWriter_fourcc(*"MJPG"), 10, (48, 40))
for i in range(6):
    writer.write(np.full((40, 48, 3), 40 * i, np.uint8))
writer.release()
capture = cv2.VideoCapture
cv2.VideoCapture = lambda index: capture(video)
assert len(tool("demo/webcam_demo_torch.py").main([tiny, "--torch-device", "cpu"])) == 3
cv2.VideoCapture = capture
det = os.path.join(tmp, "det.py")
with open(det, "w") as f:
    f.write("model = dict(type='FastRCNN', backbone=dict(type='ResNet3dSlowOnly', depth=50, "
            "base_channels=8, stage_blocks=(1, 1, 1, 1), spatial_strides=(1, 2, 2, 1)), "
            "roi_head=dict(bbox_roi_extractor=dict(type='SingleRoIExtractor3D', "
            "featmap_stride=16, output_size=4), bbox_head=dict(type='BBoxHeadAVA', "
            "in_channels=256, num_classes=5)))\n"
            "data = dict(val=dict(pipeline=[dict(type='SampleAVAFrames', clip_len=4, "
            "frame_interval=2)]))\n")
import pickle
with open(os.path.join(tmp, "boxes.pkl"), "wb") as f:
    pickle.dump({2: np.array([[4.0, 4.0, 30.0, 36.0]], np.float32)}, f)
tool("demo/demo_spatiotemporal_det_torch.py").main(
    [det, video, os.path.join(tmp, "det.mp4"), "--proposals", os.path.join(tmp, "boxes.pkl")]
    + cpu)
tool("demo/webcam_demo_spatiotemporal_det_torch.py").main(
    [det, "--input", video, "--predict-stepsize", "2"] + cpu)
os.makedirs(os.path.join(tmp, "frames", "v"))
for i in range(3):
    cv2.imwrite(os.path.join(tmp, "frames", "v", f"img_{i:05d}.jpg"), np.zeros((8, 8, 3)))
with open(os.path.join(tmp, "list.txt"), "w") as f:
    f.write("v 3 out")
tool("tools/data/activitynet/tsn_feature_extraction_torch.py").main(
    ["--data-prefix", os.path.join(tmp, "frames"), "--data-list", os.path.join(tmp, "list.txt"),
     "--output-prefix", os.path.join(tmp, "tsn"), "--frame-interval", "2"] + cpu)
tool("tools/deployment/publish_model_torch.py").main(
    [os.path.join(tmp, "work", "ckpt_1.pth"), os.path.join(tmp, "published")])
tool("tools/analysis/bench_processing_torch.py").main(
    [tiny, "--synthetic", "--batches", "1", "--batch-size", "1", "--workers", "1"])
with open(os.path.join(tmp, "videos.txt"), "w") as f:
    f.write("cam.avi 0")
tool("tools/misc/check_videos_torch.py").main([os.path.join(tmp, "videos.txt"), "--prefix", tmp])
tool("tools/data/build_rawframes_torch.py").main(
    [tmp, os.path.join(tmp, "raw"), "--level", "1", "--ext", "avi", "--num-worker", "1"])
tool("tools/data/ava/cut_videos_torch.py").main(
    [os.path.join(tmp, "frames", "v"), os.path.join(tmp, "cut"), "--start", "0"])
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
             + glob.glob(os.path.join(ROOT, "tools", "**", "*_torch.py"), recursive=True)
             + glob.glob(os.path.join(ROOT, "demo", "*_torch.py"))
             + [os.path.join(ROOT, "tests", name)
                for name in ("test_torch_cuda.py", "test_torch_gemm_design.py",
                             "test_torch_temporal_bwd.py", "test_torch_temporal_fwd.py",
                             "test_torch_row_passes.py", "torch_dist_worker.py")])
    assert len(files) > 30
    names = {os.path.relpath(f, ROOT) for f in files}
    assert {"adapt_image_models_torch/models/backbones/vit_clip.py",
            "adapt_image_models_torch/ops/flash_attention.py",
            "adapt_image_models_torch/models/backbones/resnet3d.py",
            "adapt_image_models_torch/models/backbones/slowfast.py",
            "adapt_image_models_torch/models/backbones/mobilenet.py",
            "adapt_image_models_torch/models/common.py",
            "adapt_image_models_torch/utils/precise_bn.py",
            "adapt_image_models_torch/models/necks/tpn.py",
            "adapt_image_models_torch/models/heads/trn_head.py",
            "adapt_image_models_torch/models/backbones/resnet_tin.py",
            "adapt_image_models_torch/models/backbones/densenet.py",
            "adapt_image_models_torch/models/recognizers/audio_recognizer.py",
            "adapt_image_models_torch/data/audio.py",
            "adapt_image_models_torch/data/pose.py",
            "adapt_image_models_torch/data/pose_dataset.py",
            "adapt_image_models_torch/data/activitynet.py",
            "adapt_image_models_torch/data/ssn_dataset.py",
            "adapt_image_models_torch/core/proposals.py",
            "adapt_image_models_torch/core/ssn_utils.py",
            "adapt_image_models_torch/models/localizers/bmn.py",
            "adapt_image_models_torch/models/localizers/bsn.py",
            "adapt_image_models_torch/models/localizers/ssn.py",
            "adapt_image_models_torch/models/heads/ssn_head.py",
            "adapt_image_models_torch/models/losses/bmn_loss.py",
            "adapt_image_models_torch/models/losses/ssn_loss.py",
            "adapt_image_models_torch/utils/gradcam.py",
            "adapt_image_models_torch/utils/flops.py",
            "tools/analysis/get_flops_torch.py", "tools/analysis/profile_torch.py",
            "tools/analysis/print_config_torch.py", "tools/analysis/eval_metric_torch.py",
            "tools/analysis/report_accuracy_torch.py", "tools/analysis/report_map_torch.py",
            "tools/analysis/analyze_logs_torch.py", "tools/deployment/export_torch.py",
            "tools/misc/clip_feature_extraction_torch.py",
            "tools/misc/bsn_proposal_generation_torch.py", "tools/verify_zoo_torch.py",
            "demo/demo_torch.py", "demo/demo_gradcam_torch.py",
            "demo/long_video_demo_torch.py", "demo/webcam_demo_torch.py",
            "demo/demo_spatiotemporal_det_torch.py",
            "demo/webcam_demo_spatiotemporal_det_torch.py",
            "tools/data/activitynet/tsn_feature_extraction_torch.py",
            "tools/deployment/publish_model_torch.py", "tools/analysis/check_videos_torch.py",
            "tools/misc/check_videos_torch.py", "tools/analysis/bench_processing_torch.py",
            "tools/data/_trim_torch.py", "tools/data/ava/cut_videos_torch.py",
            "tools/data/omnisource/trim_raw_video_torch.py",
            "tools/data/gym/trim_subaction_torch.py", "tools/data/gym/trim_event_torch.py",
            "tools/data/build_rawframes_torch.py", "tools/data/extract_audio_torch.py",
            "tools/data/build_audio_features_torch.py",
            "tools/data/denormalize_proposal_file_torch.py",
            "tools/data/activitynet/convert_proposal_format_torch.py",
            "tools/analysis/benchmark_torch.py",
            "tools/analysis/train_benchmark_torch.py"} <= names
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


def test_model_tools_default_to_the_card():
    """Every tool of the port that runs a model takes ``--device`` and runs
    on the GPU unless the caller asks for the CPU."""
    tools = ("tools/analysis/get_flops_torch.py", "tools/analysis/profile_torch.py",
             "tools/deployment/export_torch.py", "tools/misc/clip_feature_extraction_torch.py",
             "tools/verify_zoo_torch.py", "demo/demo_torch.py", "demo/demo_gradcam_torch.py",
             "demo/long_video_demo_torch.py", "demo/demo_spatiotemporal_det_torch.py",
             "demo/webcam_demo_spatiotemporal_det_torch.py",
             "tools/data/activitynet/tsn_feature_extraction_torch.py",
             "tools/analysis/benchmark_torch.py", "tools/analysis/train_benchmark_torch.py")
    for tool in tools:
        src = open(os.path.join(ROOT, tool)).read()
        assert 'add_argument("--device", default="cuda"' in src, tool
    # the webcam demo keeps JAX's --device, the capture device's index
    src = open(os.path.join(ROOT, "demo", "webcam_demo_torch.py")).read()
    assert 'add_argument("--torch-device", default="cuda"' in src
    import inspect
    from adapt_image_models_torch.utils.gradcam import gradcam
    assert inspect.signature(gradcam).parameters["device"].default == "cuda"


def test_dist_launchers_run_the_port():
    """tools/dist_{train,test}_torch.sh start torchrun over the port's tools
    with --launcher pytorch, never the JAX package's tools."""
    scripts = sorted(glob.glob(os.path.join(ROOT, "tools", "dist_*_torch.sh")))
    assert [os.path.basename(p) for p in scripts] == ["dist_test_torch.sh",
                                                       "dist_train_torch.sh"]
    for path in scripts:
        src = open(path).read()
        tool = os.path.basename(path)[len("dist_"):-len(".sh")] + ".py"
        assert os.access(path, os.X_OK), path
        assert "torch.distributed.run" in src and "--launcher pytorch" in src, path
        assert f'"$(dirname "$0")/{tool}"' in src, path
        assert "/train.py" not in src and "/test.py" not in src, path


def test_shell_launchers_run_the_port(tmp_path):
    """No ``*_torch.sh`` names a script of the JAX package: every Python
    file its code (not its comments) names ends in ``_torch.py``. The SLURM launchers hand each task
    torchrun's environment from SLURM's (a stand-in ``srun`` runs one task,
    rank 1 of 2 on node3, and ``PYTHON`` prints what it is given), and
    dist_clip_feature_extraction_torch.sh runs the port's extractor."""
    import re
    scripts = sorted(glob.glob(os.path.join(ROOT, "tools", "**", "*_torch.sh"), recursive=True))
    names = [os.path.relpath(p, ROOT) for p in scripts]
    assert {"tools/slurm_train_torch.sh", "tools/slurm_test_torch.sh",
            "tools/misc/dist_clip_feature_extraction_torch.sh"} <= set(names)
    for path in scripts:
        code = "".join(ln for ln in open(path) if not ln.lstrip().startswith("#"))
        named = re.findall(r"[\w./-]+\.py\b", code)
        assert named and all(n.endswith("_torch.py") for n in named), (path, named)
        assert os.access(path, os.X_OK), path
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    stubs = {
        "srun": 'while [ "$1" != bash ]; do shift; done\n'
                "SLURM_PROCID=1 SLURM_NTASKS=2 SLURM_LOCALID=1 SLURM_NTASKS_PER_NODE=2 "
                'SLURM_JOB_NODELIST="node[3-4]" exec "$@"',
        "scontrol": "echo node3; echo node4",
        "fake_python": 'echo "$RANK $WORLD_SIZE $LOCAL_RANK $LOCAL_WORLD_SIZE $MASTER_ADDR '
                       '$MASTER_PORT"; echo "$@"'}
    for name, body in stubs.items():
        (bin_dir / name).write_text("#!/usr/bin/env bash\n" + body + "\n")
        (bin_dir / name).chmod(0o755)
    env = dict(os.environ, PATH=f"{bin_dir}:{os.environ['PATH']}",
               PYTHON=str(bin_dir / "fake_python"), PORT="29611")
    for script, tool in (("slurm_train_torch.sh", "train_torch.py"),
                         ("slurm_test_torch.sh", "test_torch.py")):
        out = subprocess.run([os.path.join(ROOT, "tools", script), "part", "job", "cfg.py",
                              "--seed", "3"], env=env, capture_output=True, text=True,
                             timeout=60, check=True).stdout.splitlines()
        assert out == ["1 2 1 2 node3 29611",
                       f"{os.path.join(ROOT, 'tools', tool)} cfg.py --seed 3 --launcher pytorch"]
    out = subprocess.run([os.path.join(ROOT, "tools", "misc",
                                       "dist_clip_feature_extraction_torch.sh"),
                          "cfg.py", "out.npz", "--device", "cpu"], env=env, capture_output=True,
                         text=True, timeout=60, check=True).stdout.splitlines()
    assert out[1] == (f"{os.path.join(ROOT, 'tools', 'misc')}/clip_feature_extraction_torch.py "
                      "cfg.py out.npz --device cpu")


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke.py runs there instead")
    proc = _run_smoke(ROOT)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
