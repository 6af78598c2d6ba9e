#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adapt_image_models_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  0. device: require CUDA, print the card's name and power limit, build the
     CUDA kernels from csrc/ and print the build time;
  1. each fused op's kernel chain against its plain PyTorch version at the
     flagship shapes, x (clips*8, 197, 768) bf16 with 12 heads: 3 clips (one
     video's views, as inference_recognizer runs it), 6 clips (the
     run_evaluation batch below) and 32 clips (the timing batch);
  2. the flagship model (configs/recognition/vit/vitclip_base_k400_8frames.py,
     AIM ViT-B/16, 8 frames, bf16, attention_core="fused") on seeded random
     weights, driven through init_recognizer, inference_recognizer and
     run_evaluation on synthetic videos, with every kernel's launch count
     checked; then its kernel path against its plain path on the same
     weights and clips;
  3. timings: each op's kernel chain vs its plain version at 32 clips, and
     forward_test clips/s of the kernel path, the plain-op path and the
     framework-op ("xla") path at batch 32 and 64, with peak memory.
The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(ROOT, "configs", "recognition", "vit",
                      "vitclip_base_k400_8frames.py")
FRAMES, TOKENS, WIDTH, HEADS = 8, 197, 768, 12

# bf16 tolerance, kernel chain vs plain version: both round the same
# intermediates to bf16 and sum fp32 products in other orders, so a value
# may land a bf16 ulp or two away (one ulp is at most 2**-7 of the value)
ATOL, RTOL, MEAN_TOL = 1e-2, 1.6e-2, 1e-4
# model level, kernel path vs plain path: probabilities over 400 classes
PROB_ATOL = 1e-3


def log(*args):
    print(*args, flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def compare(name, got, want):
    """Max abs error of ``got`` against ``want``; raises past tolerance."""
    diff = (got.float() - want.float()).abs()
    excess = (diff - (ATOL + RTOL * want.float().abs())).max().item()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    rel = max_abs / max(want.float().abs().max().item(), 1e-30)
    log(f"  {name}: max_abs_err={max_abs:.3e} mean_abs_err={mean_abs:.3e} "
        f"max_err/max|ref|={rel:.3e} (tol {ATOL} + {RTOL}*|ref|, mean < {MEAN_TOL})")
    if not (excess <= 0 and mean_abs < MEAN_TOL):
        raise AssertionError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def cuda_ms(fn, iters=20, warmup=3):
    """Median milliseconds per call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def op_inputs(clips, seed):
    """Flagship-shape inputs of the three ops, weights at CLIP's init scale
    (std 0.02), adapters included."""
    import torch
    g = torch.Generator().manual_seed(seed)
    d, dh = WIDTH, WIDTH // 4

    def w(*shape, std=0.02):
        return (std * torch.randn(*shape, generator=g)).to("cuda", torch.bfloat16)

    x = torch.randn(clips * FRAMES, TOKENS, d, generator=g).to("cuda", torch.bfloat16)
    ln = ((1 + 0.1 * torch.randn(d, generator=g)).cuda(),
          (0.1 * torch.randn(d, generator=g)).cuda())
    adapter = (w(dh, d), w(dh), w(d, dh), w(d))
    attn = (w(3 * d, d), w(3 * d), w(d, d), w(d)) + adapter
    joint = (w(4 * d, d), w(4 * d), w(d, 4 * d), w(d)) + adapter
    return x, ln, attn, joint


def op_calls(clips, seed):
    """{name: (kernel call, plain call)} on the same inputs."""
    from adapt_image_models_torch import ops
    x, ln, attn, joint = op_inputs(clips, seed)
    return {
        "fused_temporal_step": (
            lambda: ops.fused_temporal_step(x, *ln, *attn, FRAMES, HEADS, False),
            lambda: ops.fused_temporal_step_plain(x, *ln, *attn, FRAMES, HEADS, False)),
        "fused_spatial_step": (
            lambda: ops.fused_spatial_step(x, *ln, *attn, HEADS, True),
            lambda: ops.fused_spatial_step_plain(x, *ln, *attn, HEADS, True)),
        "fused_joint": (
            lambda: ops.fused_joint(x, *ln, *joint, 0.5),
            lambda: ops.fused_joint_plain(x, *ln, *joint, 0.5)),
    }


@contextlib.contextmanager
def plain_ops():
    """Route the model's fused ops to their plain PyTorch versions: the
    plain path of the same model, for comparison and timing only."""
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.models import layers
    from adapt_image_models_torch.models.backbones import aim
    saved = (layers.fused_spatial_step, layers.fused_temporal_step, aim.fused_joint)
    layers.fused_spatial_step = ops.fused_spatial_step_plain
    layers.fused_temporal_step = ops.fused_temporal_step_plain
    aim.fused_joint = ops.fused_joint_plain
    try:
        yield
    finally:
        layers.fused_spatial_step, layers.fused_temporal_step, aim.fused_joint = saved


def randomize_adapters(model, seed):
    """Seeded non-zero values where the initialisers put zeros (each
    adapter's D_fc2 and the temporal embedding), so every kernel product
    shapes the output, as it would with trained adapters."""
    import torch
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".D_fc2." in name or name.endswith("temporal_embedding"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))


def main():
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.ops import _kernels

    # ---- phase 0: device and build ------------------------------------
    card = device_line()
    log(card)
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name} "
        f"count {torch.cuda.device_count()}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    _kernels.library()
    log(f"phase 0: kernels built and loaded in {time.perf_counter() - t0:.1f} s "
        f"(into {os.path.relpath(_kernels.BUILD_ROOT, ROOT)})")

    # ---- phase 1: each op vs its plain version -------------------------
    errors = {}
    for clips in (3, 6, 32):
        log(f"phase 1: ops at x=({clips * FRAMES}, {TOKENS}, {WIDTH}) bf16, "
            f"{HEADS} heads, T={FRAMES}")
        for op, (kernel, plain) in op_calls(clips, seed=clips).items():
            fn = ops.KERNEL_OPS[op][0]
            before = fn.launches
            got = kernel()
            torch.cuda.synchronize()
            if fn.launches != before + 1:
                raise AssertionError(f"{op}: launch counter did not move")
            errors[op] = compare(op, got, plain())
        torch.cuda.empty_cache()

    # ---- phase 2: the flagship model through the entry points ----------
    from adapt_image_models_torch.apis import (
        inference_recognizer, init_recognizer, load_config, run_evaluation,
    )
    cfg = load_config(CONFIG)
    backbone = cfg["model"]["backbone"]
    if backbone["attention_core"] != "fused" or backbone["width"] != WIDTH:
        raise AssertionError(f"unexpected flagship backbone {backbone}")
    t0 = time.perf_counter()
    model = init_recognizer(cfg, device="cuda", seed=0)
    randomize_adapters(model, seed=1)
    n_params = sum(p.numel() for p in model.parameters())
    log(f"phase 2: built {os.path.relpath(CONFIG, ROOT)} on cuda, "
        f"{n_params / 1e6:.1f}M params, in {time.perf_counter() - t0:.1f} s")

    n_videos, eval_batch = 4, 2
    with tempfile.TemporaryDirectory() as tmp:
        ann = os.path.join(tmp, "ann.txt")
        with open(ann, "w") as f:
            f.write("\n".join(f"synthetic://{i} {i % 400}" for i in range(n_videos)))
        cfg["data"]["test"]["ann_file"] = ann
        ops.reset_launch_counts()  # the main path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(3)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        launches = ops.launch_counts()  # ... and ends here
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    log(f"  launches on the main path ({forwards} forwards x 12 layers): {launches}")
    if any(n != 12 * forwards for n in launches.values()):
        raise AssertionError(f"expected {12 * forwards} launches of each op")
    if scores.shape != (n_videos, 400) or not (abs(scores.sum(1) - 1) < 1e-3).all():
        raise AssertionError(f"bad eval scores {scores.shape}")
    if any(not (0 <= s <= 1) for r in top5 for _, s in r):
        raise AssertionError("inference scores are not probabilities")

    # kernel path vs plain path: same weights, 2 samples x 3 views of seeded
    # uint8 clips through the device stage
    from adapt_image_models_torch.data.transforms import make_prepare_fn
    clips = np.random.default_rng(2).integers(0, 256, (2, 3, FRAMES, 224, 224, 3),
                                              dtype=np.uint8)
    imgs = make_prepare_fn(device="cuda")(clips)
    with torch.no_grad():
        p_kernel = model.forward_test(imgs)
        with plain_ops():
            p_plain = model.forward_test(imgs)
    prob_err = (p_kernel - p_plain).abs().max().item()
    top1 = (p_kernel.argmax(1) == p_plain.argmax(1)).float().mean().item()
    log(f"  model kernel path vs plain path ({tuple(imgs.shape)}): probability "
        f"max_abs_err={prob_err:.3e} (tol {PROB_ATOL}), top-1 agreement {top1:.2f}, "
        f"finite={bool(torch.isfinite(p_kernel).all())}")
    if not (prob_err < PROB_ATOL and torch.isfinite(p_kernel).all()):
        raise AssertionError("kernel path disagrees with the plain path")

    # ---- phase 3: timings ------------------------------------------------
    log(f"phase 3: timings on {card}")
    op_ms = {}
    calls = op_calls(32, seed=32)
    for op, (kernel, plain) in calls.items():
        # plain, kernel, kernel, plain
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        op_ms[op] = ((k1 + k2) / 2, (p1 + p2) / 2)
        log(f"  {op} at 32 clips: kernel {op_ms[op][0]:.3f} ms, plain "
            f"{op_ms[op][1]:.3f} ms (median of 20, CUDA events)")
    del calls
    torch.cuda.empty_cache()

    xla_cfg = {**cfg["model"], "backbone": {**backbone, "attention_core": "xla"}}
    from adapt_image_models_torch.models import build_model
    xla_model = build_model({k: v for k, v in xla_cfg.items() if k != "test_cfg"},
                            test_cfg=cfg["model"]["test_cfg"], device="cuda").eval()
    xla_model.load_state_dict(model.state_dict())
    paths = {
        "kernel": (model, contextlib.nullcontext),
        "plain-op": (model, plain_ops),
        "framework-op (xla)": (xla_model, contextlib.nullcontext),
    }
    for batch in (32, 64):
        x = torch.randn(batch, 1, 3, FRAMES, 224, 224, device="cuda")
        for label in ("plain-op", "kernel", "framework-op (xla)"):
            m, ctx = paths[label]
            torch.cuda.reset_peak_memory_stats()
            with torch.no_grad(), ctx():
                ms = cuda_ms(lambda: m.forward_test(x), iters=5, warmup=2)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  forward_test batch {batch} ({label} path): {ms:.2f} ms, "
                f"{batch / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB")
        del x
        torch.cuda.empty_cache()

    sources = {"fused_temporal_step": "adapt_image_models_torch/csrc/attention.cu",
               "fused_spatial_step": "adapt_image_models_torch/csrc/attention.cu",
               "fused_joint": "adapt_image_models_torch/csrc/gemm.cu"}
    kernels = [dict(name=op, route="cuda", source=sources[op],
                    replaces=ops.KERNEL_OPS[op][1], launches=launches[op],
                    max_abs_err=errors[op], ms=op_ms[op][0], plain_ms=op_ms[op][1])
               for op in ops.KERNEL_OPS]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
