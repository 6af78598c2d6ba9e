#!/usr/bin/env python3
"""Smoke run of the PyTorch port (adapt_image_models_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure raises and exits non-zero:
  0. device: require CUDA, print the card's name and power limit, build the
     CUDA kernels from csrc/ and print the build time;
  1. each fused eval op's kernel chain against its plain PyTorch version at
     the flagship shapes, x (clips*8, 197, 768) bf16 with 12 heads: 3 clips
     (one video's views, as inference_recognizer runs it), 6 clips (the
     run_evaluation batch below) and 32 clips (the timing batch);
  2. the eval path: the flagship model (configs/recognition/vit/
     vitclip_base_k400_8frames.py, AIM ViT-B/16, 8 frames, bf16,
     attention_core="fused") on seeded random weights, driven through
     init_recognizer, inference_recognizer and run_evaluation on synthetic
     videos, with every eval kernel's launch count checked; then its kernel
     path against its plain path on the same weights and clips;
  3. eval timings: each eval op's kernel chain vs its plain version at 32
     clips, and forward_test clips/s of the kernel path, the plain-op path
     and the framework-op ("xla") path at batch 32, with peak memory;
  4. each train op's kernels, forward and backward, against its plain
     forward and backward at the flagship shapes with 8 and 32 clips and
     drop-path gates of zeros and 1/keep: output, dx and the adapter
     cotangents;
  5. the train path: apis.train.train_model on the flagship config with
     synthetic train and val videos, 4 steps of 8 clips, then one
     validation, with every train kernel's launch count checked (12 forward
     and 12 backward launches of each train op per step), frozen weights
     bitwise unchanged, trainable ones moved, the checkpoint reloaded
     through init_recognizer and auto_resume continuing the step count;
     then one train step of the kernel path against the plain path;
  6. train timings: train-step clips/s and peak memory at 8 and 32 clips for
     the kernel path and the framework-op path, each train op's forward and
     backward vs its plain version at 32 clips, and a torch.profiler split
     of one kernel-path train step at 32 clips with the device's idle share.
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
# train ops' backward, kernel vs plain version: dx and the adapter
# cotangents have scales that vary by tensor (dx ~5, dW up to ~1e3). Both
# versions round the same intermediates; a summation-order flip moves a
# value by a bf16 ulp, which the following products carry on. The adapter
# cotangents are fp32 sums over 0.4M-1.6M rows rounded to bf16 (the
# weights' dtype, as the JAX package casts them), so up to half of their
# elements land one ulp apart (measured: mean error 0.3e-3 to 1.8e-3 of
# the mean magnitude, max error one ulp). Bounds: elementwise
# GRAD_ATOL * max|ref| + RTOL * |ref|, and a mean abs error under one ulp,
# GRAD_MEAN_REL = 2**-8 of the mean magnitude
GRAD_ATOL, GRAD_MEAN_REL = 1e-2, 2 ** -8
# one train step, kernel path vs plain path from the same weights and seed:
# the loss, and per trainable tensor sum|diff| / sum|ref| of its gradient
# and of its update. Adam's first update is about lr * sign(grad), so the
# update differs only where a gradient element near 0 flips its sign; a
# wrong or mis-scaled gradient of one tensor moves its ratio towards 1
LOSS_RTOL = 2e-3
STEP_GRAD_REL, STEP_UPDATE_REL = 2 ** -5, 2 ** -5
KEEP = 0.8  # the flagship's deepest drop-path keep probability


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


def compare_grad(name, got, want):
    """Max abs error of a backward tensor against its plain version, with
    tolerances relative to the reference's scale; returns (max abs error,
    passed)."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    scale, mean_ref = ref.max().item(), ref.mean().item()
    excess = (diff - (GRAD_ATOL * scale + RTOL * ref)).max().item()
    max_abs, mean_abs = diff.max().item(), diff.mean().item()
    ok = excess <= 0 and mean_abs <= GRAD_MEAN_REL * mean_ref
    log(f"    {name}: max_abs_err={max_abs:.3e} (max|ref| {scale:.3e}) "
        f"mean_abs_err/mean|ref|={mean_abs / max(mean_ref, 1e-30):.3e} "
        f"{'ok' if ok else 'FAILS'} (tol {GRAD_ATOL}*max|ref| + {RTOL}*|ref|, "
        f"mean < {GRAD_MEAN_REL}*mean|ref|)")
    return max_abs, ok


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
    """Route the model's fused ops, eval and train, to their plain PyTorch
    versions: the plain path of the same model, for comparison and timing
    only."""
    from adapt_image_models_torch import ops
    from adapt_image_models_torch.models import layers
    from adapt_image_models_torch.models.backbones import aim
    names = [(layers, "fused_spatial_step"), (layers, "fused_temporal_step"),
             (aim, "fused_joint"), (layers, "fused_spatial_train_step"),
             (layers, "fused_temporal_train_step"), (aim, "fused_joint_train_block")]
    saved = [getattr(mod, name) for mod, name in names]
    for mod, name in names:
        setattr(mod, name, getattr(ops, name + "_plain"))
    try:
        yield
    finally:
        for (mod, name), fn in zip(names, saved):
            setattr(mod, name, fn)


def train_op_calls(clips, seed):
    """{name: (kernel op, plain op, backward wrapper, plain backward, args,
    backward args)}: the three train ops at flagship shapes with drop-path
    gates of zeros and 1/keep; the backward args add the cotangent."""
    import torch
    from adapt_image_models_torch import ops
    x, ln, attn, joint = op_inputs(clips, seed)
    rows = x.shape[0]
    gate = torch.where(torch.arange(rows) % 5 == 2, 0.0, 1 / KEEP).cuda()
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(seed + 1))
    g = g.to("cuda", torch.bfloat16)
    gate_rows = gate.repeat_interleave(TOKENS)
    return {
        "fused_temporal": (
            ops.fused_temporal_train_step, ops.fused_temporal_train_step_plain,
            ops.fused_temporal_step_bwd_dx, ops.fused_temporal_step_bwd_dx_plain,
            (x, *ln, *attn, gate, FRAMES, HEADS, False),
            (x, gate, *ln, *attn, g, FRAMES, HEADS, False), g),
        "fused_spatial": (
            ops.fused_spatial_train_step, ops.fused_spatial_train_step_plain,
            ops.fused_step_bwd_dx, ops.fused_step_bwd_dx_plain,
            (x, *ln, *attn, None, HEADS, True),
            (x, *ln, *attn, g, HEADS, True), g),
        "fused_joint": (
            ops.fused_joint_train_block, ops.fused_joint_train_block_plain,
            ops.fused_joint_mlp_rows_bwd, ops.fused_joint_mlp_rows_bwd_plain,
            (x, *ln, *joint, gate_rows, 0.5),
            (x, g, gate_rows, *ln, *joint[:3], *joint[4:7], 0.5), g),
    }


def train_op_run(fn, args, g):
    """Forward and backward of a train op: (out, dx, dW1, db1, dW2, db2)."""
    x, ln_w, ln_b, *rest = args
    x = x.detach().clone().requires_grad_()
    frozen = rest[:4]
    adapter = [w.detach().clone().requires_grad_() for w in rest[4:8]]
    out = fn(x, ln_w, ln_b, *frozen, *adapter, *rest[8:])
    out.backward(g)
    return [out.detach(), x.grad] + [w.grad for w in adapter]


TRAIN_FWD = {"fused_temporal": "fused_temporal_train_step",
             "fused_spatial": "fused_spatial_train_step",
             "fused_joint": "fused_joint_train_block"}
TRAIN_BWD = {"fused_temporal": "fused_temporal_step_bwd_dx",
             "fused_spatial": "fused_step_bwd_dx",
             "fused_joint": "fused_joint_mlp_rows_bwd"}


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
        ops.reset_launch_counts()  # the eval path's run starts here
        top5 = [inference_recognizer(model, cfg, f"synthetic://{k}") for k in range(3)]
        results, scores, _ = run_evaluation(cfg, model=model, batch_size=eval_batch,
                                            num_workers=2, return_scores=True)
        launches = ops.launch_counts()  # ... and ends here
    forwards = len(top5) + -(-n_videos // eval_batch)
    log(f"  inference_recognizer top-5 of synthetic://0: {top5[0]}")
    log(f"  run_evaluation over {n_videos} synthetic videos: {results}")
    log(f"  launches on the eval path ({forwards} forwards x 12 layers): {launches}")
    if any(launches[op] != 12 * forwards for op in ops.EVAL_OPS) or any(
            launches[op] for op in ops.TRAIN_OPS):
        raise AssertionError(f"expected {12 * forwards} launches of each eval op "
                             "and none of the train ops")
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
    for batch in (32,):
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

    del xla_model
    torch.cuda.empty_cache()

    # ---- phase 4: each train op, forward and backward, vs its plain version
    tensors = ("out", "dx", "dW1", "db1", "dW2", "db2")
    failures = []
    for clips in (8, 32):
        log(f"phase 4: train ops at x=({clips * FRAMES}, {TOKENS}, {WIDTH}) bf16, "
            f"{HEADS} heads, T={FRAMES}, gates of 0 and 1/{KEEP}")
        for op, (kernel, plain, bwd, _, args, _, g) in train_op_calls(clips, clips).items():
            fwd_fn, bwd_fn = ops.KERNEL_OPS[TRAIN_FWD[op]][0], ops.KERNEL_OPS[TRAIN_BWD[op]][0]
            before = (fwd_fn.launches, bwd_fn.launches)
            got = train_op_run(kernel, args, g)
            torch.cuda.synchronize()
            if (fwd_fn.launches, bwd_fn.launches) != (before[0] + 1, before[1] + 1):
                raise AssertionError(f"{op}: train launch counters did not move")
            want = train_op_run(plain, args, g)
            log(f"  {op}:")
            err = compare(f"  {op} out", got[0], want[0])
            errors[TRAIN_FWD[op]] = max(err, errors.get(TRAIN_FWD[op], 0.0))
            for tensor, a, b in zip(tensors[1:], got[1:], want[1:]):
                err, ok = compare_grad(tensor, a, b)
                if tensor == "dx":
                    errors[TRAIN_BWD[op]] = max(err, errors.get(TRAIN_BWD[op], 0.0))
                if not ok:
                    failures.append(f"{op} {tensor} at {clips} clips")
            del got, want
        torch.cuda.empty_cache()
    if failures:
        raise AssertionError(f"train kernels disagree with their plain versions: {failures}")

    # ---- phase 5: the train path ---------------------------------------
    import copy
    from adapt_image_models_torch.apis import train_model
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.parallel import freeze_params
    steps, videos_per_step = 4, cfg["data"]["videos_per_gpu"]
    log(f"phase 5: train_model on {os.path.relpath(CONFIG, ROOT)}, {steps} steps of "
        f"{videos_per_step} clips, then validation")
    with tempfile.TemporaryDirectory() as tmp:
        train_ann = os.path.join(tmp, "train.txt")
        with open(train_ann, "w") as f:
            f.write("\n".join(f"synthetic://{100 + i} {i % 400}"
                              for i in range(steps * videos_per_step)))
        val_ann, n_val = os.path.join(tmp, "val.txt"), 4
        with open(val_ann, "w") as f:
            f.write("\n".join(f"synthetic://{200 + i} {i % 400}" for i in range(n_val)))
        tcfg = copy.deepcopy(cfg)
        tcfg["data"]["train"]["ann_file"] = train_ann
        tcfg["data"]["val"]["ann_file"] = val_ann
        tcfg["data"]["workers_per_gpu"] = 4
        tcfg.update(total_epochs=1, evaluation=dict(tcfg["evaluation"], interval=1),
                    checkpoint_config=dict(interval=1), log_config=dict(interval=1))
        work = os.path.join(tmp, "work")
        initial = init_recognizer(tcfg, device="cuda", seed=0).state_dict()
        t0 = time.perf_counter()
        ops.reset_launch_counts()  # the train path's run starts here
        state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=steps,
                                     device="cuda")
        torch.cuda.synchronize()
        train_launches = ops.launch_counts()  # ... and ends here
        log(f"  train_model: {state.step} steps in {time.perf_counter() - t0:.1f} s "
            f"(data, build and validation included); losses "
            f"{[round(h['loss'], 4) for h in history]}")
        log(f"  launches on the train path ({steps} steps x 12 layers, then "
            f"{n_val} validation forwards): {train_launches}")
        if any(train_launches[op] != 12 * steps for op in ops.TRAIN_OPS):
            raise AssertionError(f"expected {12 * steps} launches of each train op")
        if any(train_launches[op] != 12 * n_val for op in ops.EVAL_OPS):
            raise AssertionError("expected 12 launches of each eval op per validation video")
        if state.step != steps or not all(np.isfinite(h["loss"]) for h in history):
            raise AssertionError("train_model did not take finite steps")
        trained = state.model.state_dict()
        trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
        frozen_same = all(torch.equal(initial[n], trained[n])
                          for n in initial if n not in trainable)
        moved = sum(not torch.equal(initial[n], trained[n]) for n in trainable)
        n_train = sum(p.numel() for p in state.model.parameters() if p.requires_grad)
        log(f"  {len(trainable)} trainable tensors ({n_train / 1e6:.2f}M params), "
            f"{moved} moved; frozen bitwise unchanged: {frozen_same}")
        if not frozen_same or moved != len(trainable):
            raise AssertionError("frozen weights moved or trainable ones did not")
        mgr = CheckpointManager(work)
        reloaded = init_recognizer(tcfg, checkpoint=mgr.path(1), device="cuda")
        if not all(torch.equal(v, trained[k]) for k, v in reloaded.state_dict().items()):
            raise AssertionError("the checkpoint does not reload through init_recognizer")
        tcfg["total_epochs"] = 2
        resumed, _ = train_model(tcfg, work_dir=work, seed=0, max_steps=1,
                                 auto_resume=True, validate=False, device="cuda")
        log(f"  checkpoint reloaded through init_recognizer; auto_resume continued "
            f"from step {state.step} to {resumed.step}")
        if resumed.step != steps + 1:
            raise AssertionError("auto_resume did not continue the step count")
        del state, resumed, reloaded, initial, trained
    torch.cuda.empty_cache()

    # one train step, kernel path vs plain path, from the same weights and seed
    def train_setup(core="fused", weights=None):
        mcfg = {**cfg["model"], "backbone": {**backbone, "attention_core": core}}
        m = build_model({k: v for k, v in mcfg.items() if k != "test_cfg"},
                        test_cfg=cfg["model"]["test_cfg"], device="cuda")
        m.load_state_dict(weights)
        freeze_params(m)
        opt = build_optimizer(cfg["optimizer"], m, 3e-4)
        return TrainState(m, opt), make_train_step(m, opt)

    weights = model.state_dict()
    g_img = torch.Generator().manual_seed(3)
    batch = {"imgs": torch.randn(videos_per_step, 1, 3, FRAMES, 224, 224,
                                 generator=g_img).to("cuda", torch.bfloat16),
             "label": np.arange(videos_per_step) * 37 % 400}
    results = {}
    for label, ctx in (("kernel", contextlib.nullcontext), ("plain", plain_ops)):
        tstate, step_fn = train_setup(weights=weights)
        with ctx():
            m = step_fn(tstate, batch, 11)
        adam = tstate.optimizer.torch.state  # exp_avg = (1 - beta1) * grad
        results[label] = ({k: float(v) for k, v in m.items()},
                          {n: (p.detach().float(), adam[p]["exp_avg"].float())
                           for n, p in tstate.model.named_parameters() if p.requires_grad})
        del tstate, step_fn, adam
    (mk, pk), (mp, pp) = results["kernel"], results["plain"]

    def rel(diff, ref):
        return diff.abs().sum().item() / max(ref.abs().sum().item(), 1e-30)

    # per trainable tensor: its gradient (Adam's first moment) and its update
    per_tensor = {n: (rel(pk[n][1] - pp[n][1], pp[n][1]),
                      rel(pk[n][0] - pp[n][0], pp[n][0] - weights[n].float()))
                  for n in pp}
    log(f"  one train step, kernel vs plain path ({videos_per_step} clips, seed 11): "
        f"loss {mk['loss']:.6f} vs {mp['loss']:.6f}, grad_norm {mk['grad_norm']:.4f} vs "
        f"{mp['grad_norm']:.4f}; per tensor sum|diff| / sum|ref| (tol {STEP_GRAD_REL} "
        f"for the gradient, {STEP_UPDATE_REL} for the update):")
    for k, what in ((0, "gradient"), (1, "update")):
        worst = sorted(per_tensor, key=lambda n: -per_tensor[n][k])[:4]
        log(f"    {what}, worst 4 of {len(per_tensor)}: " + ", ".join(
            f"{n} ({pp[n][0].numel()}) {per_tensor[n][k]:.3e}" for n in worst))
    bad = [n for n, (g_rel, u_rel) in per_tensor.items()
           if g_rel > STEP_GRAD_REL or u_rel > STEP_UPDATE_REL]
    if not (abs(mk["loss"] - mp["loss"]) <= LOSS_RTOL * abs(mp["loss"])
            and abs(mk["grad_norm"] - mp["grad_norm"]) <= 1e-2 * mp["grad_norm"]
            and not bad):
        raise AssertionError("one train step of the kernel path disagrees with the "
                             f"plain path (tensors past tolerance: {bad[:8]})")
    del results, pk, pp
    torch.cuda.empty_cache()

    # ---- phase 6: train timings -----------------------------------------
    log(f"phase 6: train timings on {card}")
    for clips in (8, 32):
        timing_batch = {"imgs": torch.randn(clips, 1, 3, FRAMES, 224, 224, device="cuda",
                                            dtype=torch.bfloat16),
                        "label": np.arange(clips) % 400}
        for core, label in (("fused", "kernel"), ("xla", "framework-op (xla)")):
            tstate, step_fn = train_setup(core, weights)
            torch.cuda.reset_peak_memory_stats()
            ms = cuda_ms(lambda: step_fn(tstate, timing_batch, 0), iters=5, warmup=2)
            mem = torch.cuda.max_memory_allocated() / 2 ** 30
            log(f"  train step {clips} clips ({label} path): {ms:.2f} ms, "
                f"{clips / ms * 1e3:.1f} clips/s, peak memory {mem:.2f} GiB "
                f"(median of 5 after 2 warm-ups, CUDA events)")
            if core == "fused" and clips == 32:
                from torch.profiler import ProfilerActivity, profile
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    step_fn(tstate, timing_batch, 0)
                    torch.cuda.synchronize()
                    wall = (time.perf_counter() - t0) * 1e3
                by_kernel = {}
                for evt in prof.events():
                    if evt.device_type.name == "CUDA":
                        t, n = by_kernel.get(evt.name, (0.0, 0))
                        by_kernel[evt.name] = (t + evt.time_range.elapsed_us() / 1e3, n + 1)
                busy = sum(t for t, _ in by_kernel.values())
                log(f"  profile of one kernel-path train step at 32 clips: device time "
                    f"{busy:.1f} ms over {wall:.1f} ms wall, idle share "
                    f"{max(0.0, 1 - busy / wall) * 100:.1f}% (profiler on)")
                for key, (dev_ms, count) in sorted(by_kernel.items(),
                                                   key=lambda r: -r[1][0])[:16]:
                    log(f"    {dev_ms:9.2f} ms {100 * dev_ms / busy:5.1f}% {count:5d}x "
                        f"{key[:80]}")
            del tstate, step_fn
            torch.cuda.empty_cache()
        del timing_batch

    for op, (kernel, plain, bwd, bwd_plain, args, bargs, g) in train_op_calls(32, 32).items():
        fwdbwd = (cuda_ms(lambda: train_op_run(plain, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(kernel, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(kernel, args, g), iters=10),
                  cuda_ms(lambda: train_op_run(plain, args, g), iters=10))
        with torch.no_grad():
            fwd = (cuda_ms(lambda: plain(*args)), cuda_ms(lambda: kernel(*args)),
                   cuda_ms(lambda: kernel(*args)), cuda_ms(lambda: plain(*args)))
            bw = (cuda_ms(lambda: bwd_plain(*bargs)), cuda_ms(lambda: bwd(*bargs)),
                  cuda_ms(lambda: bwd(*bargs)), cuda_ms(lambda: bwd_plain(*bargs)))
        pair = lambda t: ((t[1] + t[2]) / 2, (t[0] + t[3]) / 2)
        op_ms[TRAIN_FWD[op]], op_ms[TRAIN_BWD[op]] = pair(fwd), pair(bw)
        log(f"  {op} train op at 32 clips: forward kernel {pair(fwd)[0]:.3f} / plain "
            f"{pair(fwd)[1]:.3f} ms; backward kernel {pair(bw)[0]:.3f} / plain "
            f"{pair(bw)[1]:.3f} ms; forward+backward (autograd, adapter dW included) "
            f"kernel {pair(fwdbwd)[0]:.3f} / plain {pair(fwdbwd)[1]:.3f} ms")
        torch.cuda.empty_cache()

    sources = {op: "adapt_image_models_torch/csrc/attention.cu"
               for op in ("fused_temporal_step", "fused_spatial_step",
                          "fused_temporal_train_step", "fused_temporal_step_bwd_dx",
                          "fused_spatial_train_step", "fused_step_bwd_dx")}
    counts = {**{op: launches[op] for op in ops.EVAL_OPS},
              **{op: train_launches[op] for op in ops.TRAIN_OPS}}
    kernels = [dict(name=op, route="cuda",
                    source=sources.get(op, "adapt_image_models_torch/csrc/gemm.cu"),
                    replaces=ops.KERNEL_OPS[op][1], launches=counts[op],
                    max_abs_err=errors[op], ms=op_ms[op][0], plain_ms=op_ms[op][1])
               for op in (*ops.EVAL_OPS, *ops.TRAIN_OPS)]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
