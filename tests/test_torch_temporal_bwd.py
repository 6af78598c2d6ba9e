"""The two temporal backward cores (``csrc/temporal_bwd.cuh``) on the CPU:
their designs, their wrappers, the segment core's three-term split of its
fp32 cotangent, and the plain versions the kernels are held to on the card.

Each core picks a branch by the frame count T: up to 144 frames the scores
of a strip stay in registers and a block forms the five products once
("registers"), past that a problem's rows are staged whole ("staged", the
full core to 384 frames, the segment core to 256) or streamed through a
ring ("streamed"), the only branch that reads the (rows, H, 3) fp32 scratch.
Here, without a card:

* the design helpers ``ops.temporal_bwd_design`` and
  ``ops.temporal_segment_bwd_design``: their branch points (144 | 145, 384
  | 385, 256 | 257), and shared memory within one block's 232,448 bytes at
  every T up to 1200, enough for the rows and tiles each branch stages;
* the wrappers ``_kernels.temporal_attention_bwd`` and
  ``_kernels.temporal_segment_bwd``: one call of the C entry a call with the
  packed QKV, dO, dqkv, o (or null) and the scratch (or null), nothing else
  allocated, so nothing of size (T, T); the scratch only on the streamed
  branch; the design held to its C twin; one count a launch;
* every temporal backward op's CUDA branch (rows 17 to 22) on fake CUDA
  tensors (``FakeTensorMode``, stand-ins for the chains' other kernels) at
  8, 145 and 300 frames: one launch of its core, the full core's for rows
  17, 18, 21 and 22 and the segment core's for rows 19 and 20;
* the segment core's split of each fp32 DO element into three bf16 terms
  (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid), as
  ``stage_split_rows`` forms them): hi + mid + lo == x in float64 for random
  x of magnitude 1e-30 to 1e30 and at the edges (2^-110 with every
  mantissa, the largest finite bf16, signed zeros), the sum of bf16(p) *
  term over the three terms equals bf16(p) * x in float64, and each such
  product is exact in fp32 where it stays in fp32's normal range;
* ``temporal_core_bwd_plain`` and ``temporal_segment_core_bwd_plain`` (1
  clip, 3 tokens, 2 heads, bf16) against the attention gradients in float64
  on the same inputs at T = 1, 8, 17, 64, 65 and 144. The full core rounds
  bf16(P) for dV, dS and the three outputs, the segment core also each
  product of a score or of dP, so an output lands within a few bf16 ulps of
  its scale: measured over the six T, max error up to 4.4e-3 / 5.8e-3 of
  max|ref| and mean error up to 2.3e-3 / 3.7e-3 of mean|ref| (full /
  segment); bounds 8e-3 / 1.2e-2 and 4e-3 / 6e-3. A rowdot left out moves
  dq or dk by 0.34-1.45 of max|ref|, a doubled scale by 1.29-3.86, so both
  fail them (at T = 1, where P = 1 and dS = 0, only the rowdot shows: dq
  and dk are then zero).

Parity of the ops with the JAX package stays in ``tests/test_torch_ops.py``
and ``tests/test_torch_longclip.py``.
"""

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    temporal_core_bwd_plain, temporal_segment_core_bwd_plain,
)

SMEM_MAX = 232448
ROW_BYTES = 144  # a staged 64-lane bf16 row with its 8 lanes of padding
STAT_BYTES = 12  # a row's fp32 (max, sum, rowdot)
DESIGNS = {"full": (ops.temporal_bwd_design, 4, "aim_temporal_bwd_design"),
           "segment": (ops.temporal_segment_bwd_design, 6, "aim_temporal_segment_bwd_design")}


# ---------------------------------------------------------------------------
# the designs


@pytest.mark.parametrize("core,frames,branch", [
    ("full", 1, "registers"), ("full", 16, "registers"), ("full", 17, "registers"),
    ("full", 64, "registers"), ("full", 65, "registers"), ("full", 144, "registers"),
    ("full", 145, "staged"), ("full", 384, "staged"), ("full", 385, "streamed"),
    ("full", 5000, "streamed"),
    ("segment", 1, "registers"), ("segment", 64, "registers"), ("segment", 65, "registers"),
    ("segment", 144, "registers"), ("segment", 145, "staged"), ("segment", 256, "staged"),
    ("segment", 257, "streamed"), ("segment", 801, "streamed")])
def test_temporal_bwd_design_branch_points(core, frames, branch):
    design, sets, _ = DESIGNS[core]
    got, smem = design(frames)
    assert got == branch
    tp = -(-frames // 16) * 16
    if branch == "registers":  # 4, 2 or 1 problems of 1, 2 or 3-9 strips, P and dS tiles
        per_block = max(1, 4 // (tp // 16))
        assert smem == per_block * (sets * tp * ROW_BYTES + 2 * tp * (tp + 8) * 2)
    elif branch == "staged":  # the row sets and the statistics
        assert smem == tp * (sets * ROW_BYTES + STAT_BYTES)
    else:  # the larger ring phase and eight warps' strips of two row sets
        ring = max(2 * 2 * 64 * ROW_BYTES, 2 * 64 * ((sets - 2) * ROW_BYTES + STAT_BYTES))
        assert smem == ring + 8 * 2 * 16 * ROW_BYTES


@pytest.mark.parametrize("core", ["full", "segment"])
def test_temporal_bwd_designs_fit_one_block_and_hold_their_rows(core):
    design, sets, _ = DESIGNS[core]
    for frames in range(1, 1201):
        branch, smem = design(frames)
        assert 0 < smem <= SMEM_MAX, (frames, smem)
        if branch == "registers":
            assert frames <= 144 and smem >= sets * frames * ROW_BYTES + 2 * frames * frames * 2
        elif branch == "staged":
            assert smem >= frames * (sets * ROW_BYTES + STAT_BYTES)
        else:  # a staged design would not fit
            assert -(-frames // 16) * 16 * (sets * ROW_BYTES + STAT_BYTES) > SMEM_MAX
    with pytest.raises(ValueError):
        design(0)


# ---------------------------------------------------------------------------
# the wrappers


class _FakeLibrary:
    """The cores' C entries: a design answers its Python twin's, a launch
    records its arguments and returns 0."""

    def __init__(self):
        self.launches = []

    def _design(self, design, frames, smem_ref):
        branch, smem = design(frames)
        smem_ref._obj.value = smem
        return ("registers", "staged", "streamed").index(branch)

    def aim_temporal_bwd_design(self, frames, smem_ref):
        return self._design(ops.temporal_bwd_design, frames, smem_ref)

    def aim_temporal_segment_bwd_design(self, frames, smem_ref):
        return self._design(ops.temporal_segment_bwd_design, frames, smem_ref)

    def aim_temporal_attention_bwd_bf16(self, *args):
        self.launches.append(("full", args))
        return 0

    def aim_temporal_segment_bwd_bf16(self, *args):
        self.launches.append(("segment", args))
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


@pytest.mark.parametrize("core", ["full", "segment"])
@pytest.mark.parametrize("frames,with_out", [(8, True), (64, False), (145, True),
                                             (300, False), (385, True)])
def test_wrapper_launches_once_and_allocates_no_tile(monkeypatch, core, frames, with_out):
    """The wrapper hands the C entry the packed QKV, dO, dqkv, o (or null)
    and the (rows, H, 3) fp32 scratch on the streamed branch only (else
    null), with (clips, T, L, D, 1/8); it allocates dqkv, o and that scratch
    and nothing else; it holds the C design to its twin and counts one
    launch a call."""
    design, _, c_design = DESIGNS[core]
    fn = _kernels.temporal_segment_bwd if core == "segment" else _kernels.temporal_attention_bwd
    lib = _FakeLibrary()
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_stream", lambda: 0)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    clips, tokens, heads = 1, 3, 2
    rows, d = clips * frames * tokens, 64 * heads
    qkv = torch.zeros(rows, 3 * d, dtype=torch.bfloat16)
    dout = torch.zeros(rows, d, dtype=torch.float32 if core == "segment" else torch.bfloat16)
    ops.reset_launch_counts()
    with _Allocations() as made:
        got = fn(qkv, dout, clips, frames, tokens, with_out=with_out)
    dqkv, out = got if with_out else (got, None)
    assert dqkv.shape == qkv.shape and dqkv.dtype == torch.bfloat16
    assert (out is None) == (not with_out)
    streamed = design(frames)[0] == "streamed"
    assert sorted(made.shapes) == sorted(
        [(rows, 3 * d)] + [(rows, d)] * with_out + [(rows * heads * 3,)] * streamed)
    ((name, args),) = lib.launches
    assert name == core
    assert args[:4] == (qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                        out.data_ptr() if with_out else None)
    assert (args[4] is None) == (not streamed)
    assert args[5:10] == (clips, frames, tokens, d, 0.125)
    assert (c_design, frames) in _kernels._designs_held
    assert fn.launches == 1
    ops.reset_launch_counts()
    assert fn.launches == 0


class _WrongDesign(_FakeLibrary):
    """A library whose designs answer 16 bytes more than their twins."""

    def _design(self, design, frames, smem_ref):
        branch = super()._design(design, frames, smem_ref)
        smem_ref._obj.value += 16
        return branch


@pytest.mark.parametrize("core", ["full", "segment"])
@pytest.mark.parametrize("frames", [144, 145, 385])
def test_wrapper_holds_the_c_design_to_its_twin(monkeypatch, core, frames):
    c_name = DESIGNS[core][2]
    monkeypatch.setattr(_kernels, "_designs_held", set())
    monkeypatch.setattr(_kernels, "library", lambda: _WrongDesign())
    with pytest.raises(RuntimeError):
        _kernels._hold_design(c_name, frames)
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary())
    _kernels._hold_design(c_name, frames)
    assert (c_name, frames) in _kernels._designs_held


# ---------------------------------------------------------------------------
# the ops' CUDA branches on fake CUDA tensors


def _stand_ins(monkeypatch):
    """The chains' other kernels return empty tensors of their outputs'
    shapes; the backward cores' launches are recorded as (core, T,
    with_out)."""
    calls = []

    def gemm(a, w, *, kn=False, out_f32=False, out_bf16=True, f32_pre_act=False, **_):
        n = w.shape[1] if kn else w.shape[0]
        new = lambda dt: torch.empty(a.shape[0], n, dtype=dt, device=a.device)  # noqa: E731
        return (new(torch.float32) if out_f32 or f32_pre_act else None,
                new(torch.bfloat16) if out_bf16 else None)

    def core_bwd(core):
        def launch(qkv, dout, clips, frames, length, with_out=False):
            calls.append((core, frames, with_out))
            dqkv = torch.empty_like(qkv)
            out = torch.empty(qkv.shape[0], qkv.shape[1] // 3, dtype=qkv.dtype,
                              device=qkv.device)
            return (dqkv, out) if with_out else dqkv
        return launch

    def forward(qkv, clips, frames, length):
        return torch.empty(qkv.shape[0], qkv.shape[1] // 3, dtype=qkv.dtype, device=qkv.device)

    monkeypatch.setattr(_kernels, "gemm", gemm)
    monkeypatch.setattr(_kernels, "layernorm", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "layernorm_bwd", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "row_scale", lambda g, *a, **k: (
        torch.empty(g.shape, dtype=torch.float32, device=g.device), torch.empty_like(g)))
    monkeypatch.setattr(_kernels, "temporal_attention", forward)
    monkeypatch.setattr(_kernels, "temporal_segment", forward)
    monkeypatch.setattr(_kernels, "temporal_attention_bwd", core_bwd("full"))
    monkeypatch.setattr(_kernels, "temporal_segment_bwd", core_bwd("segment"))
    return calls


@pytest.mark.parametrize("frames", [8, 145, 300])
def test_backward_ops_launch_their_core_once(monkeypatch, frames):
    """Rows 17 to 22 on fake CUDA tensors (2 clips, 3 tokens, width 128):
    each launches its backward core once, the full core's for rows 17, 18,
    21 and 22 (with the core's output for the LN and plain blocks' rows 17
    and 18) and the segment core's for rows 19 and 20."""
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
        outs = [ops.fused_ln_temporal_attention_bwd(x, *ln, *attn[:3], g, frames, 2)[0],
                ops.fused_temporal_attention_bwd(x, *attn[:3], g, frames, 2)[0],
                ops.fused_ln_temporal_attention_bwd_segment(x, *ln, *attn[:3], g, frames, 2)[0],
                ops.fused_ln_temporal_attention_bwd_dx_segment(x, *ln, *attn[:3], g, frames, 2),
                ops.fused_ln_temporal_attention_bwd_dx(x, *ln, *attn[:3], g, frames, 2),
                ops.fused_temporal_step_bwd_dx(x, gate, *ln, *attn, *adapter, g, frames, 2,
                                               True)[0]]
        assert all(t.shape == x.shape and t.device.type == "cuda" for t in outs)
    assert calls == [("full", frames, True), ("full", frames, True),
                     ("segment", frames, True), ("segment", frames, False),
                     ("full", frames, False), ("full", frames, False)]


# ---------------------------------------------------------------------------
# the segment core's three-term split of the fp32 cotangent


def _split3(x: torch.Tensor):
    """hi, mid, lo (bf16) of fp32 x, as ``stage_split_rows`` forms them."""
    hi = x.to(torch.bfloat16)
    r = x - hi.float()
    mid = r.to(torch.bfloat16)
    return hi, mid, (r - mid.float()).to(torch.bfloat16)


def test_three_bf16_terms_reproduce_fp32_exactly():
    rng = np.random.default_rng(1400)
    mags = 10.0 ** rng.uniform(-30, 30, 1 << 20)
    man = rng.integers(0, 1 << 23, 1 << 16)
    edges = np.concatenate([
        (1 + man / 2.0 ** 23) * 2.0 ** -110,  # the smallest exponent the split holds
        [0.0, -0.0, 1.0, -1.0, 1 + 2.0 ** -23, 1 - 2.0 ** -24, 2.0 ** -110, 1e-30, 1e30,
         float(torch.finfo(torch.bfloat16).max), 3.0e38, 2.0 ** 127]])
    x = torch.from_numpy(np.concatenate([mags * rng.choice([-1.0, 1.0], mags.size),
                                         edges]).astype(np.float32))
    hi, mid, lo = _split3(x)
    assert torch.equal(hi.double() + mid.double() + lo.double(), x.double())
    assert torch.isfinite(hi).all()
    p = torch.from_numpy(rng.uniform(0, 1, x.numel())).to(torch.bfloat16).double()
    assert torch.equal(p * hi.double() + p * mid.double() + p * lo.double(), p * x.double())
    # and each product is exact in fp32, as the tensor cores form it, where
    # it stays in fp32's normal range (the random values; not the edges at
    # 2^-110, whose lo terms times p fall below it)
    n = mags.size
    for term in (hi[:n], mid[:n], lo[:n]):
        assert torch.equal((p[:n].float() * term.float()).double(), p[:n] * term.double())


# ---------------------------------------------------------------------------
# the plain cores against float64


def _float64_grads(q, k, v, do, rowdot=True, scale=0.125):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True)) if rowdot else p * dp
    return ds @ k * scale, ds.transpose(-1, -2) @ q * scale, p.transpose(-1, -2) @ do


# (max, mean) error bounds of each plain core, relative to max|ref| and
# mean|ref| (the module docstring has the measured errors)
PLAIN_BOUNDS = {"full": (8e-3, 4e-3), "segment": (1.2e-2, 6e-3)}


def _within(got, want, bounds):
    err = (got - want).abs()
    return bool(err.max() <= bounds[0] * want.abs().max()
                and err.mean() <= bounds[1] * want.abs().mean())


@pytest.mark.parametrize("core", ["full", "segment"])
@pytest.mark.parametrize("frames", [1, 8, 17, 64, 65, 144])
def test_plain_backward_cores_against_float64(core, frames):
    """The plain core (1 clip, 3 tokens, 2 heads, bf16 q, k, v; dO bf16, or
    fp32 for the segment core) against the float64 attention gradients of
    the same inputs, within PLAIN_BOUNDS; the same gradients with rowdot
    left out or the scale doubled fall outside them."""
    clips, tokens, heads, d = 1, 3, 2, 128
    rng = np.random.default_rng(1410 + frames)
    qkv = torch.from_numpy(rng.standard_normal((frames * tokens, 3 * d))).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((frames * tokens, d))).float()
    if core == "full":
        do = do.to(torch.bfloat16)
        got = temporal_core_bwd_plain(qkv, do, clips, frames, tokens, heads)
    else:
        got = temporal_segment_core_bwd_plain(qkv, do, clips, frames, tokens, heads)[0]
    parts = [t.view(clips, frames, tokens, heads, 64).permute(0, 2, 3, 1, 4)
             for t in (*qkv.split(d, -1), do)]
    flat = lambda t: t.permute(0, 3, 1, 2, 4).reshape(-1, d)  # noqa: E731
    want = [flat(w) for w in _float64_grads(*parts)]
    got = [got[:, i * d:(i + 1) * d].double() for i in range(3)]
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        err = (a - w).abs()
        assert _within(a, w, PLAIN_BOUNDS[core]), (
            name, (err.max() / w.abs().max().clamp_min(1e-300)).item(),
            (err.mean() / w.abs().mean().clamp_min(1e-300)).item())
    faults = [dict(rowdot=False)] + ([dict(scale=0.25)] if frames > 1 else [])
    for fault in faults:
        bad = [flat(w) for w in _float64_grads(*parts, **fault)]
        assert not all(_within(b, w, PLAIN_BOUNDS[core]) for b, w in zip(bad, want)), fault
