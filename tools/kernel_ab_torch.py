#!/usr/bin/env python
"""Time the GEMM (``csrc/gemm.cu``), the spatial attention cores, the
temporal backward cores and the full temporal forward core alone, and the
TPU kernels that run the backward cores (PERF.md rows 7, 8, 9, 11 and
17-22), on one card in two source trees of the port, in turns A, B, B, A.

    python tools/kernel_ab_torch.py --a PARENT_TREE --b . [--out FILE]
        [--only "temporal forward"]   # the functions whose names hold it

Each turn is a subprocess that builds the tree's kernels from its
``adapt_image_models_torch/csrc/`` (into that tree's ``csrc/build/``) and
times them through the wrappers both trees have, ``_kernels.gemm``,
``_kernels.spatial_attention``, ``_kernels.spatial_attention_bwd``,
``_kernels.temporal_attention_bwd``, ``_kernels.temporal_segment_bwd`` and
``_kernels.temporal_attention``, at ``tools/kernel_bounds_torch.py``'s
GEMM_SHAPES, SPATIAL_SHAPES, TEMPORAL_BWD_SHAPES and TEMPORAL_FWD_SHAPES,
and the ops of ROWS at their model shapes, on inputs
made from one seed: median of 20 CUDA-event timings a function, after 3
warm-ups. The same turn times the library call of each core,
``torch.matmul`` (the product alone) and ``scaled_dot_product_attention``
on the (frames, H, L, 64) copies of q, k, v ((clips*L, H, T, 64) for a
temporal core; its autograd backward for a backward core). The table gives each tree's
mean of its two turns beside the bound of ``kernel_bounds_torch.py``, with
the card's name and power limit. Needs one NVIDIA GPU; imports no JAX.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def _ms(fn, iters=20, warmup=3):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def worker(tree, only=""):
    """Time one tree's kernels whose names hold ``only``; print one JSON
    object {name: [kernel ms, library ms]}."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    from torch.nn.functional import scaled_dot_product_attention as sdpa
    from adapt_image_models_torch.ops import _kernels
    from kernel_bounds_torch import (
        GEMM_SHAPES, SPATIAL_SHAPES, TEMPORAL_BWD_SHAPES, TEMPORAL_FWD_SHAPES,
    )
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab_torch: needs an NVIDIA GPU")
    _kernels.library()
    g = torch.Generator(device="cuda").manual_seed(2000)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda")

    def wanted(*names):
        return any(only in name for name in names)

    out = {}
    with torch.no_grad():
        for label, m, k, n, layout, epilogue in GEMM_SHAPES:
            if not wanted(f"gemm {label}"):
                continue
            a = randn(m, k).to(torch.bfloat16)
            kn = layout == "kn"
            w = (0.02 * randn(*((k, n) if kn else (n, k)))).to(torch.bfloat16)
            kw = gemm_epilogue(epilogue, m, n, g)
            out[f"gemm {label}"] = [
                _ms(lambda: _kernels.gemm(a, w, kn=kn, **kw)),
                _ms(lambda: torch.matmul(a, w if kn else w.t()))]
            del a, w, kw
            torch.cuda.empty_cache()
        for frames, heads, length in SPATIAL_SHAPES:
            if not wanted(f"spatial forward {(frames, heads, length)} prenorm",
                          f"spatial backward {(frames, heads, length)}"):
                continue
            d = 64 * heads
            qkv = randn(frames * length, 3 * d).to(torch.bfloat16)
            q, k, v = (t.view(frames, length, heads, 64).transpose(1, 2).contiguous()
                       for t in qkv.split(d, -1))
            lib = _ms(lambda: sdpa(q, k, v))
            for prenorm in (False, True):
                out[f"spatial forward {(frames, heads, length)}{' prenorm' if prenorm else ''}"] = [
                    _ms(lambda: _kernels.spatial_attention(qkv, frames, length, prenorm)), lib]
            dout = randn(frames * length, d).to(torch.bfloat16)
            do = dout.view(frames, length, heads, 64).transpose(1, 2).contiguous()
            with torch.enable_grad():
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                o = sdpa(qg, kg, vg)
                lib_bwd = _ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                                          retain_graph=True))
            out[f"spatial backward {(frames, heads, length)}"] = [
                _ms(lambda: _kernels.spatial_attention_bwd(qkv, dout, frames, length)),
                lib_bwd]
            del qkv, q, k, v, dout, do, qg, kg, vg, o
            torch.cuda.empty_cache()
        for label, clips, frames, tokens, heads in TEMPORAL_BWD_SHAPES:
            if not wanted(f"temporal backward {label}", f"segment backward {label}"):
                continue
            d, rows = 64 * heads, clips * frames * tokens
            qkv = randn(rows, 3 * d).to(torch.bfloat16)
            dout = randn(rows, d)
            q, k, v, do = (t.view(clips, frames, tokens, heads, 64).permute(0, 2, 3, 1, 4)
                           .reshape(clips * tokens, heads, frames, 64).to(torch.bfloat16)
                           .contiguous() for t in (*qkv.split(d, -1), dout))
            with torch.enable_grad():
                qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
                o = sdpa(qg, kg, vg)
                lib_bwd = _ms(lambda: torch.autograd.grad(o, (qg, kg, vg), do,
                                                          retain_graph=True))
            d16 = dout.to(torch.bfloat16)
            args = (clips, frames, tokens)
            out[f"temporal backward {label}"] = [
                _ms(lambda: _kernels.temporal_attention_bwd(qkv, d16, *args)), lib_bwd]
            out[f"segment backward {label}"] = [
                _ms(lambda: _kernels.temporal_segment_bwd(qkv, dout, *args)), lib_bwd]
            del qkv, dout, d16, q, k, v, do, qg, kg, vg, o
            torch.cuda.empty_cache()
        for label, clips, frames, tokens, heads in TEMPORAL_FWD_SHAPES:
            if not wanted(f"temporal forward {label}"):
                continue
            d = 64 * heads
            qkv = randn(clips * frames * tokens, 3 * d).to(torch.bfloat16)
            q, k, v = (t.view(clips, frames, tokens, heads, 64).permute(0, 2, 3, 1, 4)
                       .reshape(clips * tokens, heads, frames, 64).contiguous()
                       for t in qkv.split(d, -1))
            out[f"temporal forward {label}"] = [
                _ms(lambda: _kernels.temporal_attention(qkv, clips, frames, tokens)),
                _ms(lambda: sdpa(q, k, v))]
            del qkv, q, k, v
            torch.cuda.empty_cache()
        for row, *shape in ROWS:
            if not wanted(row_label(row, *shape)):
                continue
            out[row_label(row, *shape)] = [_ms(row_call(row, shape, g)), None]
            torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


# the ops that run a backward core, by PERF.md row, each at the (clips,
# frames, tokens, width) of its timed x = (clips * frames, tokens, width),
# heads width / 64: 32 clips of 8 frames, AIM_FLASH's 8 clips of 32 frames
# with the prompt token (row 8), 4 clips of 64 frames on the segment core
# (rows 17, 19, 20) and ViT-L/14's 4 clips of 32 frames (row 21)
ROWS = ((7, 32, 8, 197, 768), (8, 8, 32, 198, 768), (9, 32, 8, 197, 768),
        (11, 32, 8, 197, 768), (17, 32, 8, 197, 768), (17, 4, 64, 197, 768),
        (18, 32, 8, 197, 768), (19, 4, 64, 197, 768), (20, 4, 64, 197, 768),
        (21, 32, 8, 197, 768), (21, 4, 32, 257, 1024), (22, 32, 8, 197, 768))


def row_label(row, clips, frames, tokens, width):
    return f"row {row} x=({clips * frames}, {tokens}, {width}) T={frames}"


def row_call(row, shape, g):
    """A call of the row's op at its ROWS shape, its weights, LN and
    cotangent drawn on the card from ``g``."""
    import torch
    from adapt_image_models_torch import ops
    clips, frames, tokens, d = shape
    rows, heads = clips * frames, d // 64

    def r(*shape, s=0.05, dtype=torch.bfloat16):
        return (s * torch.randn(*shape, generator=g, device="cuda")).to(dtype)

    x, gr = r(rows, tokens, d, s=1.0), r(rows, tokens, d, s=1.0)
    ln = (1 + r(d, s=0.1, dtype=torch.float32), r(d, s=0.1, dtype=torch.float32))
    attn = (r(3 * d, d), r(3 * d), r(d, d), r(d))
    adapter = (r(d // 4, d), r(d // 4), r(d, d // 4), r(d))
    gate = torch.ones(rows, device="cuda")
    return {7: lambda: ops.fused_ln_qkv_attention_bwd(x, *ln, *attn[:3], gr, heads),
            8: lambda: ops.fused_qkv_attention_bwd(x, *attn[:3], gr, heads),
            9: lambda: ops.fused_ln_qkv_attention_bwd_dx(x, *ln, *attn[:3], gr, heads),
            11: lambda: ops.fused_step_bwd_dx(x, *ln, *attn, *adapter, gr, heads, True),
            17: lambda: ops.fused_ln_temporal_attention_bwd(x, *ln, *attn[:3], gr, frames,
                                                            heads),
            18: lambda: ops.fused_temporal_attention_bwd(x, *attn[:3], gr, frames, heads),
            19: lambda: ops.fused_ln_temporal_attention_bwd_segment(
                x, *ln, *attn[:3], gr, frames, heads),
            20: lambda: ops.fused_ln_temporal_attention_bwd_dx_segment(
                x, *ln, *attn[:3], gr, frames, heads),
            21: lambda: ops.fused_ln_temporal_attention_bwd_dx(x, *ln, *attn[:3], gr, frames,
                                                               heads),
            22: lambda: ops.fused_temporal_step_bwd_dx(x, gate, *ln, *attn, *adapter, gr,
                                                       frames, heads, True)}[row]


def gemm_epilogue(epilogue, m, n, g):
    """The ``_kernels.gemm`` arguments of a GEMM_SHAPES entry's epilogue,
    drawn on the card from the CUDA generator ``g``."""
    import torch
    from adapt_image_models_torch.ops import _kernels
    kw = {}
    if "bias" in epilogue:
        kw["bias"] = (0.02 * torch.randn(n, generator=g, device="cuda")).to(torch.bfloat16)
    if "act" in epilogue:
        kw["act"] = _kernels.ACT_GELU_TANH
    if "aux" in epilogue:
        kw["aux"] = torch.randn(m, n, generator=g, device="cuda")
        kw["dact"] = _kernels.ACT_QUICK_GELU
    if "res_f32" in epilogue:
        kw["res_f32"] = torch.randn(m, n, generator=g, device="cuda")
    if "out_f32" in epilogue:
        kw.update(out_f32=True, out_bf16=False)
    return kw


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--a", required=True, help="the first tree (the parent)")
    p.add_argument("--b", default=".", help="the second tree (the change)")
    p.add_argument("--out", help="write the turns and the table as JSON here")
    p.add_argument("--only", default="", help="time only the functions whose names hold this")
    p.add_argument("--worker", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.worker:
        sys.path.insert(0, HERE)
        return worker(args.worker, args.only)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    turns = []
    for tree in (args.a, args.b, args.b, args.a):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--a", args.a,
                               "--only", args.only, "--worker", tree],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"turn on {tree} failed:\n{proc.stderr[-4000:]}")
        turns.append((tree, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"turn {len(turns)} ({tree}): {json.dumps(turns[-1][1])}", flush=True)
    sys.path.insert(0, HERE)
    from kernel_bounds_torch import (
        GEMM_SHAPES, SPATIAL_SHAPES, TEMPORAL_BWD_SHAPES, TEMPORAL_FWD_SHAPES, bound,
        bound_of, gemm_shape_work, spatial_core_work, temporal_bwd_work, temporal_fwd_work,
    )
    bounds = {f"gemm {label}": (bound_of(*gemm_shape_work(m, k, n, e)), 2 * m * k * n)
              for label, m, k, n, _, e in GEMM_SHAPES}
    for shape in SPATIAL_SHAPES:
        for name in (f"spatial forward {shape}", f"spatial forward {shape} prenorm"):
            bounds[name] = (bound_of(*spatial_core_work(*shape)), None)
        bounds[f"spatial backward {shape}"] = (bound_of(*spatial_core_work(*shape, True)), None)
    for label, clips, frames, tokens, heads in TEMPORAL_BWD_SHAPES:
        for core in ("temporal", "segment"):
            bounds[f"{core} backward {label}"] = (bound_of(*temporal_bwd_work(
                clips, frames, tokens, heads, core == "segment")), None)
    for label, clips, frames, tokens, heads in TEMPORAL_FWD_SHAPES:
        bounds[f"temporal forward {label}"] = (bound_of(*temporal_fwd_work(
            clips, frames, tokens, heads)), None)
    for row, clips, frames, tokens, width in ROWS:
        bounds[row_label(row, clips, frames, tokens, width)] = (
            bound(row, clips=clips, frames=frames, tokens=tokens, width=width), None)
    rows = {}
    print(f"| function | A ms | B ms | library ms | bound ms | B TFLOP/s |  ({card})")
    for name in turns[0][1]:
        a = statistics.mean(t[name][0] for tree, t in (turns[0], turns[3]))
        b = statistics.mean(t[name][0] for tree, t in (turns[1], turns[2]))
        lib = (statistics.mean(t[name][1] for _, t in turns)
               if turns[0][1][name][1] is not None else None)
        (bound_ms, bound_by), flops = bounds[name]
        rate = f"{flops / b / 1e9:.0f}" if flops else ""
        rows[name] = dict(a_ms=a, b_ms=b, library_ms=lib, bound_ms=bound_ms, bound_by=bound_by)
        print(f"| {name} | {a:.4f} | {b:.4f} | {'' if lib is None else f'{lib:.4f}'} | "
              f"{bound_ms:.4f} ({bound_by}) | {rate} |")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=card, a=args.a, b=args.b, turns=turns, rows=rows), f, indent=1)


if __name__ == "__main__":
    main()
