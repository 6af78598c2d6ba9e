"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library is built at first use into
``csrc/build/<hash of the sources>/``, so an unchanged tree builds once. Nothing here runs at import: the CPU tests import every
module, and this machine may have neither ``nvcc`` nor a card.

The launchers below take CUDA tensors, allocate their outputs with
``torch.empty`` and launch on PyTorch's current stream. Every C entry
returns ``cudaGetLastError()`` after its launch; a non-zero code raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"

# GEMM epilogue activations (csrc/common.cuh::Activation)
ACT_NONE, ACT_QUICK_GELU, ACT_GELU_TANH = 0, 1, 2

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "aim_layernorm_bf16": [_P, _P, _P, _P, _I, _I, _F, _P],
    "aim_layernorm_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _F, _P],
    "aim_row_scale_bf16": [_P, _P, _I, _F, _P, _P, _I, _I, _P],
    "aim_gemm_bf16": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F,
                      _I, _I, _I, _P, _P, _P],
    "aim_spatial_attention_bf16": [_P, _P, _I, _I, _I, _F, _I, _P],
    "aim_spatial_attention_bwd_bf16": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "aim_temporal_attention_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "aim_temporal_attention_bwd_bf16": [_P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
}

_lib: Optional[ctypes.CDLL] = None


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build_library() -> Path:
    """Compile ``csrc/*.cu`` into ``csrc/build/<hash>/libaimkernels.so``
    unless that file exists. Returns its path."""
    digest = hashlib.sha256()
    for p in _sources():
        digest.update(p.name.encode())
        digest.update(p.read_bytes())
    out_dir = BUILD_ROOT / digest.hexdigest()[:16]
    lib = out_dir / "libaimkernels.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    arch = ["-gencode", "arch=compute_90a,code=sm_90a"]
    tag = os.getpid()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out_dir / f"{src.stem}.{tag}.o"
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *arch, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-I",
             str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    errors = [p.communicate()[1] for p in procs]  # waits for every one
    try:
        failed = [e for p, e in zip(procs, errors) if p.returncode != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = out_dir / f"libaimkernels.{tag}.so"
        proc = subprocess.run([nvcc, *arch, "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(rows, D) bf16 -> (rows, D) bf16, fp32 statistics and affine."""
    rows, d = x.shape
    y = torch.empty_like(x)
    _check(library().aim_layernorm_bf16(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        eps, _stream()), "aim_layernorm_bf16")
    return y


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                  g: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm backward plus the residual cotangent: x, g (rows, D) bf16,
    dy (rows, D) fp32 -> dx (rows, D) bf16."""
    rows, d = x.shape
    dx = torch.empty_like(x)
    _check(library().aim_layernorm_bwd_bf16(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), g.data_ptr(),
        dx.data_ptr(), rows, d, eps, _stream()), "aim_layernorm_bwd_bf16")
    return dx


def row_scale(g: torch.Tensor, scale: torch.Tensor, rows_per_scale: int,
              alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``g * alpha * scale[row // rows_per_scale]`` for (rows, D) bf16 g and
    fp32 scale; returns the fp32 result and its bf16 rounding."""
    rows, d = g.shape
    o32 = torch.empty((rows, d), dtype=torch.float32, device=g.device)
    o16 = torch.empty_like(g)
    _check(library().aim_row_scale_bf16(
        g.data_ptr(), scale.data_ptr(), rows_per_scale, alpha, o32.data_ptr(),
        o16.data_ptr(), rows, d, _stream()), "aim_row_scale_bf16")
    return o32, o16


def gemm(a: torch.Tensor, w: torch.Tensor, *, kn: bool = False, bias=None,
         act: int = ACT_NONE, aux=None, dact: int = ACT_NONE,
         alpha: float = 1.0, res_f32=None, row_scale=None,
         rows_per_scale: int = 1, res_bf16=None, bias2=None,
         out_f32: bool = False, out_bf16: bool = True, f32_pre_act: bool = False
         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``a @ w.T`` (w (N, K), a torch Linear weight) or, with ``kn``,
    ``a @ w`` (w (K, N)), a (M, K) bf16, with the epilogue of
    ``csrc/gemm.cu``: ``aux``/``dact`` multiply by the activation's
    derivative at a fp32 pre-activation, ``row_scale`` (fp32) scales each
    group of ``rows_per_scale`` rows, ``f32_pre_act`` stores the fp32
    result before ``act``. Returns ``(fp32 result or None, bf16 result or
    None)``."""
    m, k = a.shape
    n = w.shape[1] if kn else w.shape[0]
    o32 = torch.empty((m, n), dtype=torch.float32, device=a.device) if out_f32 else None
    o16 = torch.empty((m, n), dtype=torch.bfloat16, device=a.device) if out_bf16 else None
    _check(library().aim_gemm_bf16(
        a.data_ptr(), w.data_ptr(), m, n, k, int(kn), _ptr(bias), _ptr(bias2),
        _ptr(res_f32), _ptr(res_bf16), _ptr(aux), _ptr(row_scale),
        rows_per_scale, alpha, act, dact, int(f32_pre_act), _ptr(o32),
        _ptr(o16), _stream()), "aim_gemm_bf16")
    return o32, o16


def spatial_attention(qkv: torch.Tensor, frames: int, length: int,
                      prenorm: bool = False) -> torch.Tensor:
    """(frames*length, 3D) packed bf16 QKV -> (frames*length, D) bf16.
    ``prenorm`` normalises P before rounding it, as the TPU backward
    kernel's recompute does."""
    d = qkv.shape[1] // 3
    out = torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
    _check(library().aim_spatial_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), frames, length, d, 64 ** -0.5,
        int(prenorm), _stream()), "aim_spatial_attention_bf16")
    return out


def spatial_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, frames: int,
                          length: int, with_out: bool = False):
    """Cotangent ``dout`` (frames*length, D) of the spatial core's output ->
    packed dqkv (frames*length, 3D), all bf16. With ``with_out`` also the
    core's output recomputed from the fp32-normalised P, ``bf16(bf16(P)
    V)`` (frames*length, D): returns (dqkv, out)."""
    d = qkv.shape[1] // 3
    qp = -(-length // 64) * 64
    dqkv = torch.empty_like(qkv)
    out = torch.empty_like(dout) if with_out else None
    # bf16 P and dS of every (frame, head), (qp, qp) each, zero past length
    p = torch.empty((frames, d // 64, qp, qp), dtype=qkv.dtype, device=qkv.device)
    ds = torch.empty_like(p)
    _check(library().aim_spatial_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), p.data_ptr(),
        ds.data_ptr(), _ptr(out), frames, length, d, 64 ** -0.5, _stream()),
        "aim_spatial_attention_bwd_bf16")
    return (dqkv, out) if with_out else dqkv


def temporal_attention(qkv: torch.Tensor, clips: int, frames: int,
                       length: int) -> torch.Tensor:
    """(clips*frames*length, 3D) packed bf16 QKV -> (rows, D) bf16, each
    token attending across the frames of its clip."""
    d = qkv.shape[1] // 3
    out = torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
    _check(library().aim_temporal_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), clips, frames, length, d, 64 ** -0.5,
        _stream()), "aim_temporal_attention_bf16")
    return out


def temporal_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, clips: int,
                           frames: int, length: int, with_out: bool = False):
    """Cotangent ``dout`` (rows, D) of the temporal core's output -> packed
    dqkv (rows, 3D), all bf16. With ``with_out`` also the core's output
    recomputed from the fp32-normalised P, ``bf16(bf16(P) V)`` (rows, D),
    as the TPU backward kernels emit it: returns (dqkv, out)."""
    d = qkv.shape[1] // 3
    dqkv = torch.empty_like(qkv)
    out = torch.empty_like(dout) if with_out else None
    _check(library().aim_temporal_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), _ptr(out), clips,
        frames, length, d, 64 ** -0.5, _stream()), "aim_temporal_attention_bwd_bf16")
    return (dqkv, out) if with_out else dqkv
