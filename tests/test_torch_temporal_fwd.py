"""The full temporal forward core (``csrc/attention.cu``) on the CPU: its
design, its wrapper, the ops that launch it, and the plain version the
kernel is held to on the card.

The core picks a branch by the frame count T: up to 144 frames the scores
of a 16-frame strip stay in registers and a block owns 8 (token, clip,
head) problems (two to a strip, up to 8 frames), or 4, 2 or 1 with their q,
k and v rows ("registers"); past that one problem a block recomputes the
scores in three passes over its k and v rows staged whole ("staged", to 800
frames) or streamed through a ring ("streamed"). No branch takes a scratch.
Here, without a card:

* the design helper ``ops.temporal_fwd_design``: its branch points (8 | 9,
  144 | 145, 800 | 801) and the problems a register block owns, and shared
  memory within one block's 232,448 bytes at every T up to 1200, enough for
  the rows each branch stages;
* the wrapper ``_kernels.temporal_attention``: one call of the C entry a
  call with the packed QKV, the output, (clips, T, L, D, 1/8) and the
  stream; only the output allocated, so nothing of size (T, T) and no
  scratch; the design held to its C twin; one count a launch;
* the CUDA branch of every op that runs a temporal forward core (rows 2,
  14, 15, 16 and 23, the gated forward with and without u) on fake CUDA
  tensors (``FakeTensorMode``, stand-ins for the chains' other kernels) at
  T = 8, 32 and 33: one launch of the full core at T <= LONG_CLIP_T = 32 and
  of the segment core at 33; and row 22, the whole-step backward, which
  recomputes the full core's forward at every T;
* ``temporal_core_plain`` (1 clip, 3 tokens, 2 heads, bf16) against
  attention in float64 on the same inputs at T = 1, 8, 16, 17, 32, 33 and
  145. It rounds q, k, v (the inputs), bf16(p) for P V and o, so o lands
  within a bf16 ulp or two of its scale: measured over the seven T, max
  error up to 2.5e-3 of max|ref| and mean error up to 2.1e-3 of mean|ref|
  (0 at T = 1, where o = v); bounds 5e-3 and 4e-3. A missing division by l
  moves o by 2.6-15 of max|ref|, a doubled scale by 0.58-2.1, so both fail
  them (at T = 1, where p = l = 1, neither shows).

Parity of the ops with the JAX package stays in ``tests/test_torch_ops.py``
and ``tests/test_torch_sthv2.py``; the kernel itself is held on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 17.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import temporal_core_plain

SMEM_MAX = 232448
ROW_BYTES = 144  # a staged 64-lane bf16 row with its 8 lanes of padding


# ---------------------------------------------------------------------------
# the design


@pytest.mark.parametrize("frames,branch,per_block", [
    (1, "registers", 8), (8, "registers", 8), (9, "registers", 4), (16, "registers", 4),
    (17, "registers", 2), (32, "registers", 2), (33, "registers", 1), (64, "registers", 1),
    (65, "registers", 1), (144, "registers", 1), (145, "staged", 1), (800, "staged", 1),
    (801, "streamed", 1), (5000, "streamed", 1)])
def test_temporal_fwd_design_branch_points(frames, branch, per_block):
    got, smem = ops.temporal_fwd_design(frames)
    assert got == branch
    tp = 8 if frames <= 8 else -(-frames // 16) * 16  # two problems of 8 share a strip
    if branch == "registers":  # q, k and v rows of each problem a block owns
        assert smem == per_block * 3 * tp * ROW_BYTES
    elif branch == "staged":  # one problem's k and v rows
        assert smem == 2 * tp * ROW_BYTES
    else:  # two ring slots of 64 k rows and two of v rows
        assert smem == 2 * 2 * 64 * ROW_BYTES


def test_temporal_fwd_design_fits_one_block_and_holds_its_rows():
    for frames in range(1, 1201):
        branch, smem = ops.temporal_fwd_design(frames)
        assert 0 < smem <= SMEM_MAX, (frames, smem)
        if branch == "registers":
            assert frames <= 144 and smem >= 3 * frames * ROW_BYTES
        elif branch == "staged":
            assert frames > 144 and smem >= 2 * frames * ROW_BYTES
        else:  # a staged design would not fit
            assert 2 * -(-frames // 16) * 16 * ROW_BYTES > SMEM_MAX
    with pytest.raises(ValueError):
        ops.temporal_fwd_design(0)


# ---------------------------------------------------------------------------
# the wrapper


class _FakeLibrary:
    """The core's C entries: the design answers its Python twin's (plus
    ``extra`` bytes), a launch records its arguments and returns 0."""

    def __init__(self, extra=0):
        self.launches, self.extra = [], extra

    def aim_temporal_attention_design(self, frames, smem_ref):
        branch, smem = ops.temporal_fwd_design(frames)
        smem_ref[0] = smem + self.extra
        return ("registers", "staged", "streamed").index(branch)

    def aim_temporal_attention_bf16(self, *args):
        self.launches.append(args)
        return 0


class _Allocations(TorchDispatchMode):
    """Records the shape of every tensor an op creates."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.__name__.split(".")[0] in ("empty", "empty_like", "zeros", "zeros_like",
                                           "new_empty", "empty_strided"):
            self.shapes.append(tuple(out.shape))
        return out


@pytest.mark.parametrize("frames", [1, 8, 32, 33, 145, 801])
def test_wrapper_launches_once_and_allocates_only_the_output(monkeypatch, frames):
    """The wrapper hands the C entry the packed QKV and the output with
    (clips, T, L, D, 1/8) and the stream; it allocates the (rows, D) output
    and nothing else; it holds the C design to its twin and counts one
    launch a call."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_stream", lambda: 7)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    clips, tokens, heads = 2, 3, 2
    rows, d = clips * frames * tokens, 64 * heads
    qkv = torch.zeros(rows, 3 * d, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    with _Allocations() as made:
        out = _kernels.temporal_attention(qkv, clips, frames, tokens)
    assert out.shape == (rows, d) and out.dtype == torch.bfloat16
    assert made.shapes == [(rows, d)]
    assert lib.launches == [(qkv.data_ptr(), out.data_ptr(), clips, frames, tokens, d, 0.125, 7)]
    assert ("aim_temporal_attention_design", frames) in _kernels._designs_held
    assert _kernels.temporal_attention.launches == 1
    _kernels.temporal_attention(qkv, clips, frames, tokens)
    assert _kernels.temporal_attention.launches == 2 and len(lib.launches) == 2
    ops.reset_launch_counts()
    assert _kernels.temporal_attention.launches == 0


@pytest.mark.parametrize("frames", [144, 145, 801])
def test_wrapper_holds_the_c_design_to_its_twin(monkeypatch, frames):
    monkeypatch.setattr(_kernels, "_designs_held", set())
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary(extra=16))
    with pytest.raises(RuntimeError):
        _kernels._hold_design("aim_temporal_attention_design", frames)
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary())
    _kernels._hold_design("aim_temporal_attention_design", frames)
    assert ("aim_temporal_attention_design", frames) in _kernels._designs_held


def test_the_c_entry_is_declared():
    """ctypes gets the design entry's argument types (an int and a pointer),
    so that it passes the pointer whole."""
    assert _kernels._SIGNATURES["aim_temporal_attention_design"] == [_kernels._I, _kernels._P]
    assert "aim_temporal_attention_design" in _kernels._DESIGNS


# ---------------------------------------------------------------------------
# the ops' CUDA branches on fake CUDA tensors


def _stand_ins(monkeypatch):
    """The chains' other kernels return empty tensors of their outputs'
    shapes; the forward cores' launches are recorded as (core, T)."""
    calls = []

    def gemm(a, w, *, kn=False, out_f32=False, out_bf16=True, f32_pre_act=False, **_):
        n = w.shape[1] if kn else w.shape[0]
        new = lambda dt: torch.empty(a.shape[0], n, dtype=dt, device=a.device)  # noqa: E731
        return (new(torch.float32) if out_f32 or f32_pre_act else None,
                new(torch.bfloat16) if out_bf16 else None)

    def forward(core):
        def launch(qkv, clips, frames, length):
            calls.append((core, frames))
            return torch.empty(qkv.shape[0], qkv.shape[1] // 3, dtype=qkv.dtype,
                               device=qkv.device)
        return launch

    def backward(qkv, dout, clips, frames, length, with_out=False):
        return torch.empty_like(qkv)

    monkeypatch.setattr(_kernels, "gemm", gemm)
    monkeypatch.setattr(_kernels, "layernorm", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "layernorm_bwd", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "row_scale", lambda g, *a, **k: (
        torch.empty(g.shape, dtype=torch.float32, device=g.device), torch.empty_like(g)))
    monkeypatch.setattr(_kernels, "temporal_attention", forward("full"))
    monkeypatch.setattr(_kernels, "temporal_segment", forward("segment"))
    monkeypatch.setattr(_kernels, "temporal_attention_bwd", backward)
    return calls


@pytest.mark.parametrize("frames", [8, 32, 33])
def test_forward_ops_launch_one_core(monkeypatch, frames):
    """Rows 2, 14, 15, 16 and 23 (without and with u) on fake CUDA tensors
    (2 clips, 3 tokens, width 128): each launches one forward core, the
    full core at T <= LONG_CLIP_T and the segment core past it."""
    calls = _stand_ins(monkeypatch)
    d, clips, tokens = 128, 2, 3
    with FakeTensorMode():
        def bf(*shape):
            return torch.empty(*shape, dtype=torch.bfloat16, device="cuda")
        x = bf(clips * frames, tokens, d)
        ln = (torch.empty(d, device="cuda"), torch.empty(d, device="cuda"))
        attn = (bf(3 * d, d), bf(3 * d), bf(d, d), bf(d))
        adapter = (bf(d // 4, d), bf(d // 4), bf(d, d // 4), bf(d))
        gate = torch.empty(clips * frames, device="cuda")
        outs = [ops.fused_temporal_step(x, *ln, *attn, *adapter, frames, 2, True),
                ops.fused_temporal_attention(x, *attn, frames, 2),
                ops.fused_ln_temporal_attention(x, *ln, *attn, frames, 2),
                ops.fused_temporal_attention_adapter(x, *attn, *adapter, frames, 2, False),
                ops.fused_temporal_step_gated(x, gate, *ln, *attn, *adapter, frames, 2,
                                              True),
                ops.fused_temporal_step_gated(x, gate, *ln, *attn, *adapter, frames, 2,
                                              True, emit_u=True)[0]]
        assert all(t.shape == x.shape and t.device.type == "cuda" for t in outs)
    core = "full" if frames <= 32 else "segment"
    assert calls == [(core, frames)] * 6


@pytest.mark.parametrize("frames", [8, 33])
def test_whole_step_backward_recomputes_the_full_core(monkeypatch, frames):
    """Row 22 on fake CUDA tensors launches the full core's forward once at
    every T, as the TPU kernel recomputes it (``_bwd_cores``)."""
    calls = _stand_ins(monkeypatch)
    d, clips, tokens = 128, 2, 3
    with FakeTensorMode():
        def bf(*shape):
            return torch.empty(*shape, dtype=torch.bfloat16, device="cuda")
        x, g = bf(clips * frames, tokens, d), bf(clips * frames, tokens, d)
        ln = (torch.empty(d, device="cuda"), torch.empty(d, device="cuda"))
        attn = (bf(3 * d, d), bf(3 * d), bf(d, d), bf(d))
        adapter = (bf(d // 4, d), bf(d // 4), bf(d, d // 4), bf(d))
        gate = torch.empty(clips * frames, device="cuda")
        dx = ops.fused_temporal_step_bwd_dx(x, gate, *ln, *attn, *adapter, g, frames, 2,
                                            True)[0]
        assert dx.shape == x.shape
    assert calls == [("full", frames)]


# ---------------------------------------------------------------------------
# the plain core against float64


def _float64_attention(q, k, v, scale=0.125, divide=True):
    q, k, v = (t.double() for t in (q, k, v))
    s = q @ k.transpose(-1, -2) * scale
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = p @ v
    return o / p.sum(-1, keepdim=True) if divide else o


# (max, mean) error bounds of the plain core, relative to max|ref| and
# mean|ref| (the module docstring has the measured errors)
PLAIN_BOUNDS = (5e-3, 4e-3)


def _within(got, want):
    err = (got - want).abs()
    return bool(err.max() <= PLAIN_BOUNDS[0] * want.abs().max()
                and err.mean() <= PLAIN_BOUNDS[1] * want.abs().mean())


@pytest.mark.parametrize("frames", [1, 8, 16, 17, 32, 33, 145])
def test_plain_forward_core_against_float64(frames):
    """The plain core (1 clip, 3 tokens, 2 heads, bf16 q, k, v) against
    float64 attention of the same inputs, within PLAIN_BOUNDS; the same
    attention without the division by l or with the scale doubled falls
    outside them."""
    clips, tokens, heads, d = 1, 3, 2, 128
    rng = np.random.default_rng(1310 + frames)
    qkv = torch.from_numpy(rng.standard_normal((frames * tokens, 3 * d))).to(torch.bfloat16)
    got = temporal_core_plain(qkv, clips, frames, tokens, heads).double()
    parts = [t.view(clips, frames, tokens, heads, 64).permute(0, 2, 3, 1, 4)
             for t in qkv.split(d, -1)]
    flat = lambda t: t.permute(0, 3, 1, 2, 4).reshape(-1, d)  # noqa: E731
    want = flat(_float64_attention(*parts))
    err = (got - want).abs()
    assert _within(got, want), ((err.max() / want.abs().max()).item(),
                                (err.mean() / want.abs().mean()).item())
    faults = [dict(divide=False), dict(scale=0.25)] if frames > 1 else []
    for fault in faults:
        assert not _within(flat(_float64_attention(*parts, **fault)), want), fault
