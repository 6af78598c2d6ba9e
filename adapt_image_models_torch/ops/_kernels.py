"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled by ``nvcc`` for ``sm_90a``, one process per source
started together, and linked into one shared library with a plain C
interface, loaded with ``ctypes``. The library is built at first use into
``csrc/build/<hash of the sources>/``, so an unchanged tree builds once.
Nothing here runs at import: the CPU tests import every module, and the
machine they run on may have neither ``nvcc`` nor a card.

The launchers below take CUDA tensors, allocate their outputs with
``torch.empty`` and launch on PyTorch's current stream. Every C entry
returns ``cudaGetLastError()`` after its launch; a non-zero code raises.

Each launcher is also a registered op of the ``aim_port`` namespace
(``torch.ops.aim_port.<name>``; ``register_ops`` at the end): its CUDA
implementation is the launcher's body, with the checks that read data
pointers; its CPU implementation is the kernel's plain version; its fake
implementation gives the output shapes, so that ``torch.export``, the meta
device and ``FlopCounterMode`` (through the FLOP formulas of the GEMM and
the attention cores) trace through the kernels. A traced graph, such as an
exported program, holds the ``aim_port`` ops and launches the kernels when
it runs on CUDA tensors; loading it needs this module imported, which
registers them. No implementation gives way to another: a CUDA tensor the
kernel does not take raises.
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
from torch._subclasses.fake_tensor import FakeTensor

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
    "aim_row_pass_design": [_I, _I, _P],
    "aim_row_scale_bf16": [_P, _P, _I, _F, _P, _P, _I, _I, _P],
    "aim_gemm_bf16": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _F,
                      _I, _I, _I, _P, _P, _P],
    "aim_gemm_design": [_I, _I, _I, _I, _P],
    "aim_spatial_attention_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "aim_spatial_bwd_design": [_I, _P],
    "aim_score_orientations": [_P, _P, _P, _P, _I, _P],
    "aim_temporal_attention_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "aim_temporal_attention_design": [_I, _P],
    "aim_temporal_attention_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "aim_temporal_bwd_design": [_I, _P],
    "aim_flash_attention_bf16": [_P, _I, _P],
    "aim_flash_attention_design": [_I, _P],
    "aim_temporal_segment_bf16": [_P, _P, _I, _I, _I, _I, _F, _P],
    "aim_temporal_segment_design": [_I, _P],
    "aim_bf16_products": [_P, _P, _P, _P, _I, _P],
    "aim_temporal_segment_bwd_bf16": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "aim_temporal_segment_bwd_design": [_I, _P],
}

# the shared memory one block may hold on sm_90, and one padded staged row
# of 64 bf16 lanes (csrc/common.cuh: SMEM_BLOCK_MAX, SMEM_ROW_BYTES)
SMEM_BLOCK_MAX, SMEM_ROW_BYTES = 232448, 144
SEGMENT_RING, FLASH_RING, SPATIAL_BWD_RING, TEMPORAL_BWD_RING = 64, 64, 64, 64  # ring slot rows
TEMPORAL_FWD_RING = 64
STAT_BYTES = 12  # a row's (max, sum, rowdot) in the backward cores' fp32 scratch
# the temporal backward cores (csrc/temporal_bwd.cuh): the most frames whose
# scores stay in registers, and the warps of a register block and of a
# streamed one
TEMPORAL_BWD_REGISTERS, TEMPORAL_BWD_WARPS, TEMPORAL_BWD_STREAM_WARPS = 144, 4, 8
# the full temporal forward core (csrc/attention.cu): the most frames whose
# scores stay in registers, the most frames of the problems that share a
# strip, and the warps of a register block
TEMPORAL_FWD_REGISTERS, TEMPORAL_FWD_PAIR, TEMPORAL_FWD_WARPS = 144, 8, 4
# the GEMM's block tile rows and k depth, the stages of its ring by tile
# width, and the slack its shared memory holds to align the swizzled
# tiles plus the mbarriers (csrc/gemm.cu)
GEMM_BM, GEMM_BK = 128, 64
GEMM_STAGES = {128: 6, 256: 4}
GEMM_SMEM_EXTRA = 1024 + 128
SMS = 132  # streaming multiprocessors of an H100 SXM
# the LayerNorm row passes (csrc/layernorm.cu): the kinds in the order of
# their C numbers, the widest row held in registers, the warps of a register
# block and of a streamed one, and the blocks an SM of the register branch
# by chunks a lane (1 .. 4)
ROW_PASS_KINDS = ("forward", "backward")
ROW_PASS_REGISTERS = 1024
ROW_PASS_WARPS, ROW_PASS_STREAM_WARPS = 4, 8
ROW_PASS_BLOCKS = (8, 6, 4, 3)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def runs_kernels(t: torch.Tensor) -> bool:
    """Whether a call on ``t`` launches kernels: not on the meta device and
    not on a fake tensor (``torch.export`` traces on fake tensors). The op
    wrappers count a call only then."""
    return not (t.is_meta or isinstance(t, FakeTensor))


def traced(t: torch.Tensor) -> bool:
    """Whether a launcher given ``t`` goes through its registered op
    (``aim_port::<name>``, see the end of this module) rather than straight
    to its CUDA body: under ``torch.compile`` or ``torch.export``, on the
    meta device, or under a dispatch mode of torch's own that records the
    ops it sees (``FlopCounterMode``'s, a tracer's; not ``FakeTensorMode``,
    which gives shapes only). There the op's fake implementation gives the
    shapes, the mode sees the call, and a traced graph records it; the op's
    CUDA implementation is the same body. A plain eager call, or one under a
    mode defined outside torch, takes the body directly, with no dispatch."""
    if t.is_meta or torch.compiler.is_compiling():
        return True
    if not torch._C._len_torch_dispatch_stack():
        return False
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._python_dispatch import _get_current_dispatch_mode_stack
    return any(type(m).__module__.startswith("torch.") and not isinstance(m, FakeTensorMode)
               for m in _get_current_dispatch_mode_stack())


def segment_fwd_design(frames: int) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the segment forward core
    at ``frames`` frames, as ``csrc/temporal_segment.cu::segment_design``
    picks them: up to 64 frames the scores of a 16-frame strip stay in
    registers ("registers64"), up to 128 in twice as many ("registers128"),
    with K and V staged in rows padded to 16 frames; past 128 three passes
    recompute them from K and V staged whole in rows padded to 32 frames
    ("staged") while those fit one block, else from a double-buffered ring
    of 64-frame tiles ("streamed")."""
    if frames <= 0:
        raise ValueError(f"frames must be positive, got {frames}")
    if frames <= 128:
        return ("registers64" if frames <= 64 else "registers128",
                2 * _round_up(frames, 16) * SMEM_ROW_BYTES)
    staged = 2 * _round_up(frames, 32) * SMEM_ROW_BYTES
    if staged <= SMEM_BLOCK_MAX:
        return "staged", staged
    return "streamed", 2 * 2 * SEGMENT_RING * SMEM_ROW_BYTES


def temporal_fwd_design(frames: int) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the full temporal forward
    core at ``frames`` frames, as ``csrc/attention.cu::temporal_fwd_design``
    picks them: up to 144 frames a strip's scores stay in registers and a
    block owns 8 (token, clip, head) problems of up to 8 frames, two to a
    strip of 16 rows, each with its q, k and v rows padded to 8 frames, or
    4, 2 or 1 problems of 1, 2 or 3-9 strips of 16 frames, their rows
    padded to 16 frames ("registers"); past that one problem a block
    recomputes the scores in three passes over its k and v rows staged
    whole ("staged") while they fit, else streamed through a double-buffered
    ring of 64-frame tiles ("streamed"). No branch takes a scratch."""
    if frames <= 0:
        raise ValueError(f"frames must be positive, got {frames}")
    tp = _round_up(frames, 16)
    if frames <= TEMPORAL_FWD_PAIR:
        return "registers", 2 * TEMPORAL_FWD_WARPS * 3 * TEMPORAL_FWD_PAIR * SMEM_ROW_BYTES
    if frames <= TEMPORAL_FWD_REGISTERS:
        per_block = max(1, TEMPORAL_FWD_WARPS // (tp // 16))
        return "registers", per_block * 3 * tp * SMEM_ROW_BYTES
    staged = 2 * tp * SMEM_ROW_BYTES
    if staged <= SMEM_BLOCK_MAX:
        return "staged", staged
    return "streamed", 2 * 2 * TEMPORAL_FWD_RING * SMEM_ROW_BYTES


def flash_fwd_design(length: int) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the flash core at
    ``length`` keys, as ``csrc/flash_attention.cu::flash_design`` picks
    them: K and V of a (batch, head) staged whole in rows padded to 16
    ("staged") while they fit one block, else streamed twice through a
    double-buffered ring of 64-key tiles ("streamed")."""
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    staged = 2 * _round_up(length, 16) * SMEM_ROW_BYTES
    if staged <= SMEM_BLOCK_MAX:
        return "staged", staged
    return "streamed", 2 * 2 * FLASH_RING * SMEM_ROW_BYTES


def spatial_bwd_design(length: int) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the spatial backward core
    at ``length`` tokens, as ``csrc/spatial_bwd.cu::spatial_bwd_design``
    picks them, the shared memory its columns kernel takes (the larger of
    its two): Q, dO and their rows' statistics staged whole in rows padded to
    16 ("staged") while they fit one block, else streamed through a
    double-buffered ring of 64-row tiles ("streamed"); its rows kernel
    stages K and V the same way."""
    if length <= 0:
        raise ValueError(f"length must be positive, got {length}")
    staged = _round_up(length, 16) * (2 * SMEM_ROW_BYTES + STAT_BYTES)
    if staged <= SMEM_BLOCK_MAX:
        return "staged", staged
    return "streamed", 2 * SPATIAL_BWD_RING * (2 * SMEM_ROW_BYTES + STAT_BYTES)


def _temporal_bwd_design(frames: int, row_sets: int) -> Tuple[str, int]:
    if frames <= 0:
        raise ValueError(f"frames must be positive, got {frames}")
    tp = _round_up(frames, 16)
    if frames <= TEMPORAL_BWD_REGISTERS:
        per_block = max(1, TEMPORAL_BWD_WARPS // (tp // 16))
        return "registers", per_block * (row_sets * tp * SMEM_ROW_BYTES + 2 * tp * (tp + 8) * 2)
    staged = tp * (row_sets * SMEM_ROW_BYTES + STAT_BYTES)
    if staged <= SMEM_BLOCK_MAX:
        return "staged", staged
    ring = max(2 * 2 * TEMPORAL_BWD_RING * SMEM_ROW_BYTES,
               2 * TEMPORAL_BWD_RING * ((row_sets - 2) * SMEM_ROW_BYTES + STAT_BYTES))
    return "streamed", ring + TEMPORAL_BWD_STREAM_WARPS * 2 * 16 * SMEM_ROW_BYTES


def temporal_bwd_design(frames: int) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the full temporal core's
    backward at ``frames`` frames, as ``csrc/temporal_bwd.cuh::
    temporal_bwd_design`` picks them: up to 144 frames a strip's scores stay
    in registers and a block owns 4, 2 or 1 (token, clip, head) problems of
    1, 2 or 3-9 strips of 16 frames, each with its q, k, v and dO rows
    padded to 16 frames and its (T, T) bf16 P and dS tiles ("registers");
    past that one problem a block, its rows and their statistics staged
    whole ("staged") while they fit, else a double-buffered ring of 64-frame
    tiles and the strips of 16 rows of its eight warps ("streamed"), the
    only branch that reads the (rows, H, 3) fp32 scratch."""
    return _temporal_bwd_design(frames, 4)


def temporal_segment_bwd_design(frames: int) -> Tuple[str, int]:
    """``temporal_bwd_design`` for the segment core's backward, whose fp32
    dO is staged as three bf16 terms (hi, mid, lo): six row sets where the
    full core has four."""
    return _temporal_bwd_design(frames, 6)


def gemm_design(m: int, n: int, k: int, kn: bool = False) -> Tuple[str, int]:
    """(branch, dynamic shared memory in bytes) of the GEMM at (m, k) @ (k,
    n), the weight (n, k) or with ``kn`` (k, n), as
    ``csrc/gemm.cu::gemm_design`` picks them: 128 x 256 block tiles
    ("bn256") where n holds at least two 256-wide tiles and the tiles make
    a full wave on the card's 132 SMs, else 128 x 128 ("bn128"); a ring of
    6 or 4 stages of the 128 x 64 A tile and the 64-deep B tile, 192 KB
    either way. Both layouts take the same tiles. TMA reads rows in 16-byte
    units, so k and n must be multiples of 8."""
    if m < 0 or n <= 0 or k <= 0 or n % 8 or k % 8:
        raise ValueError(f"gemm: (m, n, k) = ({m}, {n}, {k}) needs m >= 0 and positive n, k "
                         "divisible by 8")
    tiles_m = -(-m // GEMM_BM)
    bn = 256 if n >= 512 and tiles_m * -(-n // 256) >= SMS else 128
    stage = 2 * GEMM_BK * (GEMM_BM + bn)
    return f"bn{bn}", GEMM_STAGES[bn] * stage + GEMM_SMEM_EXTRA


def row_pass_design(kind: str, d: int) -> Tuple[str, int, int, int]:
    """(branch, chunks a lane, warps a block, blocks an SM) of the LayerNorm
    ``kind`` ("forward" or "backward") at width ``d``, as
    ``csrc/layernorm.cu::row_pass_design`` picks them (both kinds alike): a
    lane holds its CPL = ceil(d / 256) chunks of 8 values of a row in
    registers, with a grid of persistent 4-warp blocks, ROW_PASS_BLOCKS[CPL
    - 1] an SM, walking the rows ("registers"), up to d = 1024; past that
    one warp a row, 8 rows a block, sweeping it from L1 ("streamed", CPL
    and blocks an SM 0)."""
    if kind not in ROW_PASS_KINDS:
        raise ValueError(f"row pass kind must be one of {ROW_PASS_KINDS}, got {kind!r}")
    if d <= 0 or d % 8:
        raise ValueError(f"row pass: D={d} must be a positive multiple of 8")
    if d > ROW_PASS_REGISTERS:
        return "streamed", 0, ROW_PASS_STREAM_WARPS, 0
    cpl = -(-d // 256)
    return "registers", cpl, ROW_PASS_WARPS, ROW_PASS_BLOCKS[cpl - 1]


_DESIGNS = {
    "aim_temporal_segment_design": (
        segment_fwd_design, ("registers64", "registers128", "staged", "streamed")),
    "aim_flash_attention_design": (flash_fwd_design, ("staged", "streamed")),
    "aim_temporal_attention_design": (temporal_fwd_design, ("registers", "staged", "streamed")),
    "aim_spatial_bwd_design": (spatial_bwd_design, ("staged", "streamed")),
    "aim_temporal_bwd_design": (temporal_bwd_design, ("registers", "staged", "streamed")),
    "aim_temporal_segment_bwd_design": (
        temporal_segment_bwd_design, ("registers", "staged", "streamed")),
    "aim_gemm_design": (gemm_design, ("bn128", "bn256")),
    "aim_row_pass_design": (lambda kind, d: row_pass_design(ROW_PASS_KINDS[kind], d),
                            ("registers", "streamed")),
}
_designs_held = set()


def _hold_design(c_name: str, *size: int) -> None:
    """Raise unless the kernel's C design function picks the branch and the
    numbers that its Python twin does at ``size`` (a length, the GEMM's (m,
    n, k, kn), a row pass's (kind number, D)); once a size. The twin returns
    (branch, *numbers) and the C function writes the numbers (the shared
    memory; a row pass's chunks a lane, warps a block and blocks an SM) to
    the ints its last argument points at."""
    key = (c_name, *size)
    if key in _designs_held:
        return
    plain, branches = _DESIGNS[c_name]
    want = plain(*size)
    numbers = (ctypes.c_int * (len(want) - 1))()
    code = getattr(library(), c_name)(*size, numbers)
    got = (branches[code] if 0 <= code < len(branches) else code, *numbers)
    if got != want:
        raise RuntimeError(f"{c_name}{size} = {got}, its Python twin says {want}")
    _designs_held.add(key)


class _FlashArgs(ctypes.Structure):
    """``FlashArgs`` of ``csrc/flash_attention.cu``: q, k, v, o and their
    (batch, head, row) strides in elements."""
    _fields_ = [("q", _P), ("k", _P), ("v", _P), ("o", _P),
                ("sq", ctypes.c_longlong * 3), ("sk", ctypes.c_longlong * 3),
                ("sv", ctypes.c_longlong * 3), ("so", ctypes.c_longlong * 3),
                ("B", _I), ("H", _I), ("L", _I), ("scale", _F)]

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
    """The raw handle of the current device's current CUDA stream (what
    ``torch.cuda.current_stream().cuda_stream`` gives, without building a
    Stream object a call: several microseconds of a short kernel's host
    time)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def _check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code}")


def _row_pass_args(name: str, x: torch.Tensor, bf16=(), f32=(), vectors=(), like_x=(),
                   unaligned=()) -> Tuple[int, int]:
    """(rows, D) of a row pass's (rows, D) ``x``; raise ``ValueError`` unless
    every given tensor is a contiguous CUDA tensor on x's device, of its
    dtype (x and ``bf16`` bf16, ``f32`` and ``unaligned`` fp32), 16-byte
    aligned (the kernels read rows and vectors in 16-byte pieces;
    ``unaligned`` is read by the element), D a positive multiple of 8,
    ``vectors`` of shape (D,) and ``like_x`` of x's shape. Nothing here needs
    the library. The checks take the cheapest tensor attributes: a call's
    host time counts wherever the card waits for it."""
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (rows, D), got {tuple(x.shape)}")
    rows, d = x.shape
    if d <= 0 or d % 8:
        raise ValueError(f"{name}: D={d} must be a positive multiple of 8")
    device = x.get_device()
    for dtype, tensors, aligned in ((torch.bfloat16, (x, *bf16), True),
                                    (torch.float32, f32, True),
                                    (torch.float32, unaligned, False)):
        for t in tensors:
            if not t.is_cuda:
                raise ValueError(f"{name}: the kernel takes CUDA tensors, got one on {t.device}")
            if t.get_device() != device:
                raise ValueError(f"{name}: all tensors must be on {x.device}, got {t.device}")
            if t.dtype is not dtype:
                raise ValueError(f"{name}: x and g must be bf16; gamma, beta, dy and scale "
                                 f"fp32; got {t.dtype}")
            if not t.is_contiguous():
                raise ValueError(f"{name}: tensors must be contiguous")
            if aligned and t.data_ptr() & 15:
                raise ValueError(f"{name}: tensors must be 16-byte aligned")
    for t in vectors:
        if t.dim() != 1 or t.size(0) != d:
            raise ValueError(f"{name}: gamma and beta must be ({d},), got {tuple(t.shape)}")
    for t in like_x:
        if t.size() != x.size():
            raise ValueError(f"{name}: dy and g must be {tuple(x.shape)}, got {tuple(t.shape)}")
    return rows, d


def layernorm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """(rows, D) bf16 -> (rows, D) bf16, fp32 statistics and affine (fp32
    ``weight`` and ``bias``), in one launch of the design
    ``row_pass_design("forward", D)`` picks. Each launch adds one to
    ``launches``. Registered as ``aim_port::layernorm``."""
    if traced(x):
        return torch.ops.aim_port.layernorm(x, weight, bias, eps)
    return _layernorm(x, weight, bias, eps)


def _layernorm(x, weight, bias, eps):
    rows, d = _row_pass_args("layernorm", x, f32=(weight, bias), vectors=(weight, bias))
    _hold_design("aim_row_pass_design", 0, d)  # kind 0: the forward
    y = torch.empty_like(x)
    _check(library().aim_layernorm_bf16(
        x.data_ptr(), weight.data_ptr(), bias.data_ptr(), y.data_ptr(), rows, d,
        eps, _stream()), "aim_layernorm_bf16")
    layernorm.launches += 1
    return y


layernorm.launches = 0


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, weight: torch.Tensor,
                  g: Optional[torch.Tensor] = None,
                  eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm backward plus the residual cotangent: x, g (rows, D) bf16,
    dy (rows, D) fp32, fp32 ``weight`` -> dx (rows, D) bf16, in one launch
    of the design ``row_pass_design("backward", D)`` picks. With no ``g``
    the LN backward alone, as the dX-only backwards close. Each launch adds
    one to ``launches``. Registered as ``aim_port::layernorm_bwd``."""
    if traced(x):
        return torch.ops.aim_port.layernorm_bwd(x, dy, weight, g, eps)
    return _layernorm_bwd(x, dy, weight, g, eps)


def _layernorm_bwd(x, dy, weight, g, eps):
    given = () if g is None else (g,)
    rows, d = _row_pass_args("layernorm_bwd", x, bf16=given, f32=(dy, weight),
                             vectors=(weight,), like_x=(dy, *given))
    _hold_design("aim_row_pass_design", 1, d)  # kind 1: the backward
    dx = torch.empty_like(x)
    _check(library().aim_layernorm_bwd_bf16(
        x.data_ptr(), dy.data_ptr(), weight.data_ptr(), _ptr(g),
        dx.data_ptr(), rows, d, eps, _stream()), "aim_layernorm_bwd_bf16")
    layernorm_bwd.launches += 1
    return dx


layernorm_bwd.launches = 0


def row_scale(g: torch.Tensor, scale: torch.Tensor, rows_per_scale: int,
              alpha: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """``g * alpha * scale[row // rows_per_scale]`` for (rows, D) bf16 g and
    fp32 scale of one value a group of ``rows_per_scale`` rows; returns the
    fp32 result and its bf16 rounding. Each launch adds one to
    ``launches``. Registered as ``aim_port::row_scale``."""
    if traced(g):
        return torch.ops.aim_port.row_scale(g, scale, rows_per_scale, alpha)
    return _row_scale(g, scale, rows_per_scale, alpha)


def _row_scale(g, scale, rows_per_scale, alpha):
    rows, d = _row_pass_args("row_scale", g, unaligned=(scale,))
    if rows_per_scale <= 0:
        raise ValueError(f"row_scale: rows_per_scale={rows_per_scale} must be positive")
    if tuple(scale.shape) != (-(-rows // rows_per_scale),):
        raise ValueError(f"row_scale: scale must be ({-(-rows // rows_per_scale)},), one a "
                         f"group of {rows_per_scale} rows, got {tuple(scale.shape)}")
    o32 = torch.empty((rows, d), dtype=torch.float32, device=g.device)
    o16 = torch.empty_like(g)
    _check(library().aim_row_scale_bf16(
        g.data_ptr(), scale.data_ptr(), rows_per_scale, alpha, o32.data_ptr(),
        o16.data_ptr(), rows, d, _stream()), "aim_row_scale_bf16")
    row_scale.launches += 1
    return o32, o16


row_scale.launches = 0


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
    None)``. a and w must be contiguous and 16-byte aligned, k and n
    multiples of 8 (``gemm_design``). Each launch adds one to ``launches``.
    Registered as ``aim_port::gemm``, which returns the results asked for
    as a list."""
    args = (a, w, kn, bias, act, aux, dact, alpha, res_f32, row_scale, rows_per_scale,
            res_bf16, bias2, out_f32, out_bf16, f32_pre_act)
    if not traced(a):
        return _gemm(*args)
    outs = iter(torch.ops.aim_port.gemm(*args))
    return (next(outs) if out_f32 else None), (next(outs) if out_bf16 else None)


def _gemm_shape(a, w, kn):
    """(m, n, k) of ``gemm``'s product; raise ``ValueError`` where the
    operands disagree or ``gemm_design`` refuses them."""
    m, k = a.shape
    n = w.shape[1] if kn else w.shape[0]
    if (w.shape[0] if kn else w.shape[1]) != k:
        raise ValueError(f"gemm: a {tuple(a.shape)} and w {tuple(w.shape)} (kn={kn}) disagree")
    gemm_design(m, n, k, kn)  # raises on what the kernel does not take
    return m, n, k


def _gemm(a, w, kn, bias, act, aux, dact, alpha, res_f32, row_scale, rows_per_scale,
          res_bf16, bias2, out_f32, out_bf16, f32_pre_act):
    m, n, k = _gemm_shape(a, w, kn)
    for t in (a, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("gemm: a and w must be contiguous and 16-byte aligned")
    _hold_design("aim_gemm_design", m, n, k, int(kn))
    o32 = torch.empty((m, n), dtype=torch.float32, device=a.device) if out_f32 else None
    o16 = torch.empty((m, n), dtype=torch.bfloat16, device=a.device) if out_bf16 else None
    _check(library().aim_gemm_bf16(
        a.data_ptr(), w.data_ptr(), m, n, k, int(kn), _ptr(bias), _ptr(bias2),
        _ptr(res_f32), _ptr(res_bf16), _ptr(aux), _ptr(row_scale),
        rows_per_scale, alpha, act, dact, int(f32_pre_act), _ptr(o32),
        _ptr(o16), _stream()), "aim_gemm_bf16")
    gemm.launches += 1
    return o32, o16


gemm.launches = 0


def gemm_plain(a: torch.Tensor, w: torch.Tensor, *, kn: bool = False, bias=None,
               act: int = ACT_NONE, aux=None, dact: int = ACT_NONE,
               alpha: float = 1.0, res_f32=None, row_scale=None,
               rows_per_scale: int = 1, res_bf16=None, bias2=None,
               out_f32: bool = False, out_bf16: bool = True, f32_pre_act: bool = False
               ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The plain version of ``gemm``, with its arguments and results: the
    product of the upcast operands in fp32, then the epilogue in fp32 in
    ``csrc/gemm.cu``'s order, rounded once at the end."""
    from adapt_image_models_torch.ops._common import (
        gelu_tanh, gelu_tanh_grad, quick_gelu, quick_gelu_grad,
    )
    acts = {ACT_NONE: lambda v: v, ACT_QUICK_GELU: quick_gelu, ACT_GELU_TANH: gelu_tanh}
    grads = {ACT_NONE: torch.ones_like, ACT_QUICK_GELU: quick_gelu_grad,
             ACT_GELU_TANH: gelu_tanh_grad}
    v = a.float() @ (w.float() if kn else w.float().t())
    if bias is not None:
        v = v + bias.float()
    pre = v if f32_pre_act else None
    v = acts[act](v)
    if aux is not None:
        v = v * grads[dact](aux)
    v = v * alpha
    if res_f32 is not None:
        v = res_f32 + v
    if row_scale is not None:
        rows = torch.arange(v.shape[0], device=v.device) // rows_per_scale
        v = v * row_scale[rows][:, None]
    if res_bf16 is not None:
        v = res_bf16.float() + v
    if bias2 is not None:
        v = v + bias2.float()
    return (pre if f32_pre_act else (v if out_f32 else None),
            v.to(torch.bfloat16) if out_bf16 else None)


def spatial_views(qkv: torch.Tensor, out: torch.Tensor, frames: int, length: int):
    """The (frames, H, length, 64) q, k, v views of the packed (frames*length,
    3D) QKV, strides (length*3D, 64, 3D), and the view of the (frames*length,
    D) ``out`` in which the flash core writes o: what ``spatial_attention``
    hands the flash core."""
    d = qkv.shape[1] // 3
    q, k, v = (t.view(frames, length, d // 64, 64).transpose(1, 2)
               for t in qkv.split(d, dim=1))
    return q, k, v, out.view(frames, length, d // 64, 64).transpose(1, 2)


def spatial_attention(qkv: torch.Tensor, frames: int, length: int,
                      prenorm: bool = False) -> torch.Tensor:
    """(frames*length, 3D) packed bf16 QKV -> (frames*length, D) bf16: the
    flash core (``flash_attention``) on the views ``spatial_views`` makes.
    ``prenorm`` normalises P before rounding it, as the TPU backward
    kernel's recompute does. Each launch adds one to ``launches``.
    Registered as ``aim_port::spatial_attention``."""
    if traced(qkv):
        return torch.ops.aim_port.spatial_attention(qkv, frames, length, prenorm)
    return _spatial_attention(qkv, frames, length, prenorm)


def _spatial_attention(qkv, frames, length, prenorm):
    out = torch.empty((qkv.shape[0], qkv.shape[1] // 3), dtype=qkv.dtype, device=qkv.device)
    flash_attention(*spatial_views(qkv, out, frames, length), prenorm=prenorm)
    spatial_attention.launches += 1
    return out


spatial_attention.launches = 0


def spatial_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, frames: int,
                          length: int, with_out: bool = False):
    """Cotangent ``dout`` (frames*length, D) of the spatial core's output ->
    packed dqkv (frames*length, 3D), all bf16, in two launches
    (``csrc/spatial_bwd.cu``: rows, then columns) that share a scratch of
    three floats a (frame, head, row), in the design ``spatial_bwd_design``
    picks for ``length``. With ``with_out`` also the core's output
    recomputed from the fp32-normalised P, ``bf16(bf16(P) V)``
    (frames*length, D): returns (dqkv, out). Each call adds one to
    ``launches``. Registered as ``aim_port::spatial_attention_bwd``, which
    returns a list."""
    if traced(qkv):
        outs = torch.ops.aim_port.spatial_attention_bwd(qkv, dout, frames, length, with_out)
        return tuple(outs) if with_out else outs[0]
    return _spatial_attention_bwd(qkv, dout, frames, length, with_out)


def _spatial_attention_bwd(qkv, dout, frames, length, with_out):
    d = qkv.shape[1] // 3
    dqkv = torch.empty_like(qkv)
    out = torch.empty_like(dout) if with_out else None
    stats = _row_stats(qkv)
    _hold_design("aim_spatial_bwd_design", length)
    _check(library().aim_spatial_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), _ptr(out),
        stats.data_ptr(), frames, length, d, 64 ** -0.5, _stream()),
        "aim_spatial_attention_bwd_bf16")
    spatial_attention_bwd.launches += 1
    return (dqkv, out) if with_out else dqkv


spatial_attention_bwd.launches = 0


def score_orientations(q: torch.Tensor, k: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fp32 scores of (n, 64) bf16 q and k (n a multiple of 16) in the
    two orientations the spatial backward core forms them by mma.sync:
    ``q k^T`` (its rows kernel) and the transpose of ``k q^T`` (its columns
    kernel), each (n, n)."""
    n = q.shape[0]
    if q.shape != (n, 64) or k.shape != (n, 64) or n % 16 or not (
            q.is_contiguous() and k.is_contiguous()):
        raise ValueError("score_orientations: q and k must be contiguous (n, 64), n % 16 == 0")
    s = torch.empty((n, n), dtype=torch.float32, device=q.device)
    t = torch.empty_like(s)
    _check(library().aim_score_orientations(q.data_ptr(), k.data_ptr(), s.data_ptr(),
                                            t.data_ptr(), n, _stream()),
           "aim_score_orientations")
    return s, t


def spatial_attention_r(qkv: torch.Tensor, frames: int, length: int,
                        r: int) -> torch.Tensor:
    """``spatial_attention`` for the TPU kernel that groups ``r`` frames a
    grid cell (the last group may be short): the grouping means nothing to
    the flash core's launch, so this is the same launch, and the same
    output bit for bit at every r."""
    if r < 1:
        raise ValueError(f"spatial_attention_r: r={r} < 1")
    return spatial_attention(qkv, frames, length)


def _row_stats(qkv: torch.Tensor) -> torch.Tensor:
    """Scratch of the spatial backward core and of the temporal backward
    cores' streamed branch: (max, sum, rowdot) of every (row, head) of the
    packed QKV, three fp32 each."""
    d = qkv.shape[1] // 3
    return torch.empty(qkv.shape[0] * (d // 64) * 3, dtype=torch.float32,
                       device=qkv.device)


def temporal_attention(qkv: torch.Tensor, clips: int, frames: int,
                       length: int) -> torch.Tensor:
    """The full temporal core (``csrc/attention.cu``): (clips*frames*length,
    3D) packed bf16 QKV -> (rows, D) bf16, each token attending across the
    frames of its clip, with the TPU masked-full core's casts (unnormalised
    P rounded for P V, the fp32 sum divided by the fp32 row sum), in one
    launch in the design ``temporal_fwd_design`` picks for ``frames``. Only
    the output is allocated. Each launch adds one to ``launches``.
    Registered as ``aim_port::temporal_attention``."""
    if traced(qkv):
        return torch.ops.aim_port.temporal_attention(qkv, clips, frames, length)
    return _temporal_attention(qkv, clips, frames, length)


def _temporal_attention(qkv, clips, frames, length):
    d = qkv.shape[1] // 3
    out = torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
    _hold_design("aim_temporal_attention_design", frames)
    _check(library().aim_temporal_attention_bf16(
        qkv.data_ptr(), out.data_ptr(), clips, frames, length, d, 64 ** -0.5,
        _stream()), "aim_temporal_attention_bf16")
    temporal_attention.launches += 1
    return out


temporal_attention.launches = 0


def temporal_attention_bwd(qkv: torch.Tensor, dout: torch.Tensor, clips: int,
                           frames: int, length: int, with_out: bool = False):
    """Cotangent ``dout`` (rows, D) of the temporal core's output -> packed
    dqkv (rows, 3D), all bf16, in one launch of ``csrc/temporal_bwd.cuh`` in
    the design ``temporal_bwd_design`` picks for ``frames``. With
    ``with_out`` also the core's output recomputed from the fp32-normalised
    P, ``bf16(bf16(P) V)`` (rows, D), as the TPU backward kernels emit it:
    returns (dqkv, out). Each launch adds one to ``launches``. Registered
    as ``aim_port::temporal_attention_bwd``, which returns a list."""
    if traced(qkv):
        outs = torch.ops.aim_port.temporal_attention_bwd(qkv, dout, clips, frames, length,
                                                         with_out)
        return tuple(outs) if with_out else outs[0]
    return _temporal_attention_bwd(qkv, dout, clips, frames, length, with_out)


def _temporal_attention_bwd(qkv, dout, clips, frames, length, with_out):
    d = qkv.shape[1] // 3
    dqkv = torch.empty_like(qkv)
    out = torch.empty_like(dout) if with_out else None
    stats = _row_stats(qkv) if temporal_bwd_design(frames)[0] == "streamed" else None
    _hold_design("aim_temporal_bwd_design", frames)
    _check(library().aim_temporal_attention_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), _ptr(out), _ptr(stats), clips,
        frames, length, d, 64 ** -0.5, _stream()), "aim_temporal_attention_bwd_bf16")
    temporal_attention_bwd.launches += 1
    return (dqkv, out) if with_out else dqkv


temporal_attention_bwd.launches = 0


def temporal_segment(qkv: torch.Tensor, clips: int, frames: int,
                     length: int) -> torch.Tensor:
    """The segment-sum temporal core (``csrc/temporal_segment.cu``):
    (clips*frames*length, 3D) packed bf16 QKV -> (rows, D) bf16, with the
    TPU segment body's casts (bf16-rounded products, P normalised before it
    is rounded, no final division), in the design ``segment_fwd_design``
    picks for ``frames``. Each launch adds one to ``launches``. Registered
    as ``aim_port::temporal_segment``."""
    if traced(qkv):
        return torch.ops.aim_port.temporal_segment(qkv, clips, frames, length)
    return _temporal_segment(qkv, clips, frames, length)


def _temporal_segment(qkv, clips, frames, length):
    d = qkv.shape[1] // 3
    out = torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
    _hold_design("aim_temporal_segment_design", frames)
    _check(library().aim_temporal_segment_bf16(
        qkv.data_ptr(), out.data_ptr(), clips, frames, length, d, 64 ** -0.5,
        _stream()), "aim_temporal_segment_bf16")
    temporal_segment.launches += 1
    return out


temporal_segment.launches = 0


def temporal_segment_bwd(qkv: torch.Tensor, dout: torch.Tensor, clips: int,
                         frames: int, length: int, with_out: bool = False):
    """Backward of the segment core for the fp32 cotangent ``dout`` (rows,
    D) of its output: packed bf16 dqkv (rows, 3D), in one launch of
    ``csrc/temporal_bwd.cuh`` in the design ``temporal_segment_bwd_design``
    picks for ``frames``; with ``with_out`` also the core's output
    recomputed, (dqkv, out). Each launch adds one to ``launches``.
    Registered as ``aim_port::temporal_segment_bwd``, which returns a
    list."""
    if traced(qkv):
        outs = torch.ops.aim_port.temporal_segment_bwd(qkv, dout, clips, frames, length,
                                                       with_out)
        return tuple(outs) if with_out else outs[0]
    return _temporal_segment_bwd(qkv, dout, clips, frames, length, with_out)


def _temporal_segment_bwd(qkv, dout, clips, frames, length, with_out):
    d = qkv.shape[1] // 3
    dqkv = torch.empty_like(qkv)
    out = (torch.empty((qkv.shape[0], d), dtype=qkv.dtype, device=qkv.device)
           if with_out else None)
    stats = _row_stats(qkv) if temporal_segment_bwd_design(frames)[0] == "streamed" else None
    _hold_design("aim_temporal_segment_bwd_design", frames)
    _check(library().aim_temporal_segment_bwd_bf16(
        qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(), _ptr(out), _ptr(stats), clips,
        frames, length, d, 64 ** -0.5, _stream()), "aim_temporal_segment_bwd_bf16")
    temporal_segment_bwd.launches += 1
    return (dqkv, out) if with_out else dqkv


temporal_segment_bwd.launches = 0


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    o: Optional[torch.Tensor] = None, prenorm: bool = False) -> torch.Tensor:
    """softmax(q k^T / 8) v over (B, H, L, 64) bf16 q, k, v, read through
    their strides (head dim contiguous, the other strides multiples of 8
    elements). The output is (B, H, L, 64) laid out as (B, L, H, 64), so
    that ``o.transpose(1, 2).reshape(B, L, H * 64)`` is a view, or written
    through the strides of the given ``o``. ``prenorm`` normalises P by the
    row sum before rounding it (the divisor then 1). Registered, without
    ``o``, as ``aim_port::flash_attention``."""
    if o is None and traced(q):
        return torch.ops.aim_port.flash_attention(q, k, v, prenorm)
    return _flash_attention(q, k, v, o, prenorm)


def _flash_attention(q, k, v, o=None, prenorm=False):
    b, h, n, hd = q.shape
    for t in (q, k, v):
        if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError("flash_attention: q, k, v need a contiguous head dim, "
                             "strides in multiples of 8 elements and 16-byte alignment")
    if o is None:
        o = torch.empty((b, n, h, hd), dtype=q.dtype, device=q.device).transpose(1, 2)
    args = _FlashArgs(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                      (ctypes.c_longlong * 3)(*q.stride()[:3]),
                      (ctypes.c_longlong * 3)(*k.stride()[:3]),
                      (ctypes.c_longlong * 3)(*v.stride()[:3]),
                      (ctypes.c_longlong * 3)(*o.stride()[:3]),
                      b, h, n, 1.0 / (hd ** 0.5))
    _hold_design("aim_flash_attention_design", n)
    _check(library().aim_flash_attention_bf16(ctypes.byref(args), int(prenorm), _stream()),
           "aim_flash_attention_bf16")
    return o


def bf16_products(a: torch.Tensor, b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The bf16 products of the segment forward core, ``__hmul2`` on packed
    pairs, beside ``__floats2bfloat162_rn`` of the fp32 product, for
    contiguous bf16 ``a`` and ``b`` of one even size: (packed, rounded)."""
    if a.shape != b.shape or a.numel() % 2 or not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("bf16_products: a and b must be contiguous, of one even size")
    packed, rounded = torch.empty_like(a), torch.empty_like(a)
    _check(library().aim_bf16_products(
        a.data_ptr(), b.data_ptr(), packed.data_ptr(), rounded.data_ptr(),
        a.numel() // 2, _stream()), "aim_bf16_products")
    return packed, rounded


# ---------------------------------------------------------------------------
# The launchers as registered ops (``torch.ops.aim_port.<name>``)

NAMESPACE = "aim_port"


def _rows_out(qkv: torch.Tensor) -> torch.Tensor:
    """A (rows, D) tensor of the packed (rows, 3D) QKV's dtype and device."""
    return qkv.new_empty((qkv.shape[0], qkv.shape[1] // 3))


def _heads(qkv: torch.Tensor) -> int:
    return qkv.shape[1] // 3 // 64


def _flash_out(q: torch.Tensor) -> torch.Tensor:
    """(B, H, L, 64) laid out as (B, L, H, 64), as the flash core writes o."""
    b, h, n, hd = q.shape
    return q.new_empty((b, n, h, hd)).transpose(1, 2)


def _plain(name: str):
    """The kernel's plain version from ``_common`` (imported at the call:
    ``_common`` imports this module)."""
    from adapt_image_models_torch.ops import _common
    return getattr(_common, name)


def _layernorm_cpu(x, weight, bias, eps):
    return _plain("layer_norm_fp32")(x, weight, bias, eps).to(x.dtype)


def _layernorm_bwd_cpu(x, dy, weight, g, eps):
    return _plain("layer_norm_bwd_plain")(x, dy, weight, g, eps).to(x.dtype)


def _row_scale_cpu(g, scale, rows_per_scale, alpha):
    rows = torch.arange(g.shape[0]) // rows_per_scale
    o32 = g.float() * alpha * scale[rows][:, None]
    return o32, o32.to(g.dtype)


def _gemm_cpu(a, w, kn, bias, act, aux, dact, alpha, res_f32, row_scale, rows_per_scale,
              res_bf16, bias2, out_f32, out_bf16, f32_pre_act):
    _gemm_shape(a, w, kn)
    o32, o16 = gemm_plain(a, w, kn=kn, bias=bias, act=act, aux=aux, dact=dact, alpha=alpha,
                          res_f32=res_f32, row_scale=row_scale,
                          rows_per_scale=rows_per_scale, res_bf16=res_bf16, bias2=bias2,
                          out_f32=out_f32, out_bf16=out_bf16, f32_pre_act=f32_pre_act)
    return [t for t in (o32, o16) if t is not None]


def _gemm_fake(a, w, kn, bias, act, aux, dact, alpha, res_f32, row_scale, rows_per_scale,
               res_bf16, bias2, out_f32, out_bf16, f32_pre_act):
    m, n, _ = _gemm_shape(a, w, kn)
    return ([a.new_empty((m, n), dtype=torch.float32)] * out_f32
            + [a.new_empty((m, n), dtype=torch.bfloat16)] * out_bf16)


def _flash_attention_cpu(q, k, v, prenorm):
    from adapt_image_models_torch.ops.flash_attention import flash_attention_core_plain
    o = _flash_out(q)
    o.copy_(flash_attention_core_plain(q, k, v, prenorm))
    return o


def _spatial_attention_cpu(qkv, frames, length, prenorm):
    return _plain("spatial_core_plain")(qkv, frames, length, _heads(qkv), prenorm)


def _spatial_attention_bwd_cpu(qkv, dout, frames, length, with_out):
    dqkv = _plain("spatial_core_bwd_plain")(qkv, dout, frames, length, _heads(qkv))
    if not with_out:
        return [dqkv]
    return [dqkv, _plain("spatial_core_plain")(qkv, frames, length, _heads(qkv), True)]


def _temporal_attention_cpu(qkv, clips, frames, length):
    return _plain("temporal_core_plain")(qkv, clips, frames, length, _heads(qkv))


def _temporal_attention_bwd_cpu(qkv, dout, clips, frames, length, with_out):
    dqkv = _plain("temporal_core_bwd_plain")(qkv, dout, clips, frames, length, _heads(qkv))
    if not with_out:
        return [dqkv]
    return [dqkv, _plain("temporal_core_plain")(qkv, clips, frames, length, _heads(qkv),
                                                True)]


def _temporal_segment_cpu(qkv, clips, frames, length):
    return _plain("temporal_segment_core_plain")(qkv, clips, frames, length, _heads(qkv))


def _temporal_segment_bwd_cpu(qkv, dout, clips, frames, length, with_out):
    dqkv, o = _plain("temporal_segment_core_bwd_plain")(qkv, dout, clips, frames, length,
                                                        _heads(qkv))
    return [dqkv, o] if with_out else [dqkv]


def _bwd_fake(qkv, dout, *size_and_with_out):
    return [torch.empty_like(qkv)] + [_rows_out(qkv)] * size_and_with_out[-1]


# FLOP formulas, in the shapes ``FlopCounterMode`` hands them: each counts
# the products of the plain version's matmuls, two operations a
# multiply-add, so that a count over the kernel route equals one over the
# plain route; the segment core's scores, which its plain version forms
# as elementwise products the counter does not see, are counted as the
# products they are.
def _gemm_flops(a, w, kn, *_, out_shape=None, **__):
    return 2 * a[0] * a[1] * (w[1] if kn else w[0])


def _spatial_flops(qkv, frames, length, *_, out_shape=None, **__):
    return 4 * frames * length * length * (qkv[1] // 3)


def _spatial_bwd_flops(qkv, dout, frames, length, with_out, out_shape=None, **__):
    return (10 + 4 * with_out) * frames * length * length * (qkv[1] // 3)


def _temporal_flops(qkv, clips, frames, length, out_shape=None, **__):
    return 4 * clips * length * frames * frames * (qkv[1] // 3)


def _temporal_bwd_flops(qkv, dout, clips, frames, length, with_out, out_shape=None, **__):
    return (10 + 4 * with_out) * clips * length * frames * frames * (qkv[1] // 3)


def _segment_bwd_flops(qkv, dout, clips, frames, length, with_out, out_shape=None, **__):
    # scores and dP (both as elementwise products), dq, dk, dV and the output
    return 12 * clips * length * frames * frames * (qkv[1] // 3)


def _flash_flops(q, k, v, prenorm, out_shape=None, **__):
    return 4 * q[0] * q[1] * q[2] * q[2] * q[3]


_OPS = {  # name: (schema, CUDA body, plain version, fake, FLOP formula)
    "layernorm": ("(Tensor x, Tensor weight, Tensor bias, float eps) -> Tensor",
                  _layernorm, _layernorm_cpu,
                  lambda x, *_: torch.empty_like(x), None),
    "layernorm_bwd": (
        "(Tensor x, Tensor dy, Tensor weight, Tensor? g, float eps) -> Tensor",
        _layernorm_bwd, _layernorm_bwd_cpu,
        lambda x, *_: torch.empty_like(x), None),
    "row_scale": ("(Tensor g, Tensor scale, int rows_per_scale, float alpha) -> (Tensor, Tensor)",
                  _row_scale, _row_scale_cpu,
                  lambda g, *_: (torch.empty_like(g, dtype=torch.float32), torch.empty_like(g)),
                  None),
    "gemm": ("(Tensor a, Tensor w, bool kn, Tensor? bias, int act, Tensor? aux, int dact, "
             "float alpha, Tensor? res_f32, Tensor? row_scale, int rows_per_scale, "
             "Tensor? res_bf16, Tensor? bias2, bool out_f32, bool out_bf16, "
             "bool f32_pre_act) -> Tensor[]",
             lambda *a: [t for t in _gemm(*a) if t is not None], _gemm_cpu, _gemm_fake,
             _gemm_flops),
    "flash_attention": ("(Tensor q, Tensor k, Tensor v, bool prenorm) -> Tensor",
                        lambda q, k, v, prenorm: _flash_attention(q, k, v, None, prenorm),
                        _flash_attention_cpu, lambda q, *_: _flash_out(q), _flash_flops),
    "spatial_attention": ("(Tensor qkv, int frames, int length, bool prenorm) -> Tensor",
                          _spatial_attention, _spatial_attention_cpu,
                          lambda qkv, *_: _rows_out(qkv), _spatial_flops),
    "spatial_attention_bwd": (
        "(Tensor qkv, Tensor dout, int frames, int length, bool with_out) -> Tensor[]",
        lambda *a: list(_spatial_attention_bwd(*a)) if a[-1] else [_spatial_attention_bwd(*a)],
        _spatial_attention_bwd_cpu, _bwd_fake, _spatial_bwd_flops),
    "temporal_attention": ("(Tensor qkv, int clips, int frames, int length) -> Tensor",
                           _temporal_attention, _temporal_attention_cpu,
                           lambda qkv, *_: _rows_out(qkv), _temporal_flops),
    "temporal_attention_bwd": (
        "(Tensor qkv, Tensor dout, int clips, int frames, int length, bool with_out) "
        "-> Tensor[]",
        lambda *a: list(_temporal_attention_bwd(*a)) if a[-1] else [_temporal_attention_bwd(*a)],
        _temporal_attention_bwd_cpu, _bwd_fake, _temporal_bwd_flops),
    "temporal_segment": ("(Tensor qkv, int clips, int frames, int length) -> Tensor",
                         _temporal_segment, _temporal_segment_cpu,
                         lambda qkv, *_: _rows_out(qkv), _temporal_flops),
    "temporal_segment_bwd": (
        "(Tensor qkv, Tensor dout, int clips, int frames, int length, bool with_out) "
        "-> Tensor[]",
        lambda *a: list(_temporal_segment_bwd(*a)) if a[-1] else [_temporal_segment_bwd(*a)],
        _temporal_segment_bwd_cpu, _bwd_fake, _segment_bwd_flops),
}


def register_ops() -> None:
    """Register every launcher of ``_OPS`` as ``aim_port::<name>`` (once;
    importing this module does it) with its CUDA body, its plain version
    for CPU tensors, its fake implementation and, for the GEMM and the
    attention cores, its FLOP formula."""
    if hasattr(torch.ops.aim_port, "gemm"):
        return
    from torch.utils.flop_counter import register_flop_formula
    for name, (schema, cuda, cpu, fake, flops) in _OPS.items():
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", cuda, mutates_args=(),
                                     device_types="cuda", schema=schema)
        op.register_kernel("cpu")(cpu)
        op.register_fake(fake)
        if flops is not None:
            register_flop_formula(getattr(torch.ops.aim_port, name))(flops)


register_ops()
