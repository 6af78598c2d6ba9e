"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a`` into one shared library
with a plain C interface, loaded with ``ctypes``. The library is built at
first use into ``csrc/build/<hash of the sources>/``, so an unchanged tree
builds once. Nothing here runs at import: the CPU tests import every
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
    "aim_gemm_bf16": [_P, _P, _I, _I, _I, _P, _P, _P, _P, _F, _I, _P, _P, _P],
    "aim_spatial_attention_bf16": [_P, _P, _I, _I, _I, _F, _P],
    "aim_temporal_attention_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
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
    tmp = out_dir / f"libaimkernels.{os.getpid()}.so"
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC),
           "-o", str(tmp)] + [str(p) for p in _sources() if p.suffix == ".cu"]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
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


def gemm(a: torch.Tensor, w: torch.Tensor, *, bias=None, act: int = ACT_NONE,
         alpha: float = 1.0, res_f32=None, res_bf16=None, bias2=None,
         out_f32: bool = False, out_bf16: bool = True
         ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """``a @ w.T`` (a (M, K) bf16, w (N, K) bf16) with the epilogue of
    ``csrc/gemm.cu``. Returns ``(fp32 result or None, bf16 result or None)``."""
    m, k = a.shape
    n = w.shape[0]
    o32 = torch.empty((m, n), dtype=torch.float32, device=a.device) if out_f32 else None
    o16 = torch.empty((m, n), dtype=torch.bfloat16, device=a.device) if out_bf16 else None
    _check(library().aim_gemm_bf16(
        a.data_ptr(), w.data_ptr(), m, n, k, _ptr(bias), _ptr(bias2),
        _ptr(res_f32), _ptr(res_bf16), alpha, act, _ptr(o32), _ptr(o16),
        _stream()), "aim_gemm_bf16")
    return o32, o16


def spatial_attention(qkv: torch.Tensor, frames: int, length: int) -> torch.Tensor:
    """(frames*length, 3D) packed bf16 QKV -> (frames*length, D) bf16."""
    d = qkv.shape[1] // 3
    out = torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
    _check(library().aim_spatial_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), frames, length, d, 64 ** -0.5,
        _stream()), "aim_spatial_attention_bf16")
    return out


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
