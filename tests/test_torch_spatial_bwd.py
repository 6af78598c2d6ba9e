"""The spatial attention ops with no token bound, and the design of the
spatial backward core (``csrc/spatial_bwd.cu``), on the CPU.

The spatial forward core (the flash core) streams its keys past what one
block stages, and so does the backward core: its rows kernel (dQ, o and the
rows' (max, sum, rowdot)) and its columns kernel (dK, dV) stage a frame's
rows whole while they fit one block's shared memory and stream them through
a ring of 64-row tiles past that. So no spatial op refuses a token count.
Here, without a card:

* every spatial op's CUDA branch, forward (rows 4, 5, 6, 10) and backward
  (rows 7, 8, 9, 11), routes L = 289 and L = 801 to its core with no
  refusal: the tensors are fake CUDA tensors (``FakeTensorMode``, shapes and
  devices with no data), the chain's other kernels are stand-ins that
  return empty outputs of the right shapes, and the core launches are
  recorded;
* the core's wrapper: one call of the C entry with the packed QKV, dO,
  dqkv, o and a scratch of three floats a (row, head), and nothing of size
  (L, L); its design held to the C twin; one count a call;
* the design helper ``ops.spatial_bwd_design``: its branch point (768
  tokens staged, 769 streamed) and shared memory within one block's
  232,448 bytes on every branch, enough for the rows each stages;
* ``spatial_core_bwd_plain``, which the kernel is held to on the card,
  against the attention gradients in float64 on the same bf16 inputs at
  the branch points. It rounds dS, bf16(P) for dV and the three outputs to
  bf16, so an output element lands within a few bf16 ulps of its scale
  (measured over the five lengths: max error up to 4.3e-3 of max|ref|,
  mean error up to 2.3e-3 of mean|ref|); bounds 8e-3 of max|ref| and 4e-3
  of mean|ref|. Leaving out the rounding of P or of dS stays inside them
  (the gap is the outputs' rounding); a rowdot left out (0.71, 0.43) or a
  doubled scale (1.0, 1.0) does not;
* the port's plain block (``fused_qkv_attention_plain`` and the backward of
  ``fused_attention_block_plain``) against the JAX op in Pallas interpret
  mode at L = 289, 2 heads of width 128, numpy-seeded inputs, within the
  bf16 bounds of ``tests/test_torch_ops.py`` (their absolute terms scaled
  by the magnitude of the weight cotangents, see ``_close``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu
from torch._subclasses.fake_tensor import FakeTensorMode

from adapt_image_models_tpu.ops import fused_qkv_attention as jax_ops
from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import spatial_core_bwd_plain

SMEM_MAX = 232448
ROW_BYTES = 144  # a staged 64-lane bf16 row with its 8 lanes of padding
STAT_BYTES = 12  # a row's fp32 (max, sum, rowdot)
LENGTHS = (289, 801)
# tests/test_torch_ops.py's bf16 bounds: elementwise 2**-7 |ref| + 1e-3, mean
# absolute error 1e-4
BF16_RTOL, BF16_ATOL, BF16_MEAN_TOL = 2 ** -7, 1e-3, 1e-4


# ---------------------------------------------------------------------------
# the ops' CUDA branches at L = 289 and 801, on fake CUDA tensors


def _stand_ins(monkeypatch):
    """Replace the kernels of the chains with stand-ins that return empty
    tensors of the outputs' shapes; the two spatial cores' launches are
    recorded as ("fwd", q's (B, H, L, 64), prenorm) and ("bwd", frames, L,
    heads, with_out)."""
    calls = []

    def gemm(a, w, *, kn=False, out_f32=False, out_bf16=True, f32_pre_act=False, **_):
        n = w.shape[1] if kn else w.shape[0]
        new = lambda dt: torch.empty(a.shape[0], n, dtype=dt, device=a.device)  # noqa: E731
        return (new(torch.float32) if out_f32 or f32_pre_act else None,
                new(torch.bfloat16) if out_bf16 else None)

    def flash_attention(q, k, v, o=None, prenorm=False):
        calls.append(("fwd", tuple(q.shape), prenorm))
        return o

    def spatial_attention_bwd(qkv, dout, frames, length, with_out=False):
        calls.append(("bwd", frames, length, qkv.shape[1] // 192, with_out))
        dqkv = torch.empty_like(qkv)
        return (dqkv, torch.empty_like(dout)) if with_out else dqkv

    monkeypatch.setattr(_kernels, "gemm", gemm)
    monkeypatch.setattr(_kernels, "layernorm", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "layernorm_bwd", lambda x, *a, **k: torch.empty_like(x))
    monkeypatch.setattr(_kernels, "row_scale", lambda g, *a, **k: (
        torch.empty(g.shape, dtype=torch.float32, device=g.device), torch.empty_like(g)))
    monkeypatch.setattr(_kernels, "flash_attention", flash_attention)
    monkeypatch.setattr(_kernels, "spatial_attention_bwd", spatial_attention_bwd)
    return calls


def _fake_args(length, frames=2, d=128):
    """x, g, LN (fp32), the block's weights and an adapter's, bf16, on the
    fake device "cuda"."""
    def bf(*shape):
        return torch.empty(*shape, dtype=torch.bfloat16, device="cuda")

    x, g = bf(frames, length, d), bf(frames, length, d)
    ln = (torch.empty(d, device="cuda"), torch.empty(d, device="cuda"))
    attn = (bf(3 * d, d), bf(3 * d), bf(d, d), bf(d))
    adapter = (bf(d // 4, d), bf(d // 4), bf(d, d // 4), bf(d))
    return x, g, ln, attn, adapter


@pytest.mark.parametrize("length", LENGTHS)
def test_forward_ops_route_any_length_to_the_flash_core(monkeypatch, length):
    """Rows 4, 5, 6 and 10 on fake CUDA tensors at L tokens: no refusal,
    one flash launch each on the (frames, heads, L, 64) views, no prenorm,
    an output of x's shape."""
    calls = _stand_ins(monkeypatch)
    with FakeTensorMode():
        x, _, ln, attn, adapter = _fake_args(length)
        outs = [ops.fused_qkv_attention(x, *attn, 2),
                ops.fused_ln_qkv_attention(x, *ln, *attn, 2),
                ops.fused_qkv_attention_adapter(x, *attn, *adapter, 2, True),
                ops.fused_ln_qkv_attention_r(x, *ln, *attn, 2, 2)]
        assert all(o.shape == x.shape and o.device.type == "cuda" for o in outs)
    assert calls == [("fwd", (2, 2, length, 64), False)] * 4


@pytest.mark.parametrize("length", LENGTHS)
def test_backward_ops_route_any_length_to_the_backward_core(monkeypatch, length):
    """Rows 7, 8, 9 and 11 on fake CUDA tensors at L tokens: no refusal,
    one launch each of the spatial backward core, with the core's output
    for rows 7 and 8 (the plain and LN blocks' backwards) and after the
    prenorm forward recompute for row 11."""
    calls = _stand_ins(monkeypatch)
    with FakeTensorMode():
        x, g, ln, attn, adapter = _fake_args(length)
        dx7 = ops.fused_ln_qkv_attention_bwd(x, *ln, *attn[:3], g, 2)[0]
        dx8 = ops.fused_qkv_attention_bwd(x, *attn[:3], g, 2)[0]
        dx9 = ops.fused_ln_qkv_attention_bwd_dx(x, *ln, *attn[:3], g, 2)
        dx11 = ops.fused_step_bwd_dx(x, *ln, *attn, *adapter, g, 2, True)[0]
        assert all(t.shape == x.shape for t in (dx7, dx8, dx9, dx11))
    assert calls == [("bwd", 2, length, 2, True), ("bwd", 2, length, 2, True),
                     ("bwd", 2, length, 2, False), ("fwd", (2, 2, length, 64), True),
                     ("bwd", 2, length, 2, False)]


# ---------------------------------------------------------------------------
# the core's wrapper and its design


class _FakeLibrary:
    """The core's C entries: the design answers its Python twin's (or
    ``wrong``), the launch records its arguments and returns 0."""

    def __init__(self, wrong=None):
        self.launches, self.wrong = [], wrong

    def aim_spatial_bwd_design(self, length, smem_ref):
        branch, smem = self.wrong or ops.spatial_bwd_design(length)
        smem_ref[0] = smem
        return ("staged", "streamed").index(branch)

    def aim_spatial_attention_bwd_bf16(self, *args):
        self.launches.append(args)
        return 0


@pytest.mark.parametrize("length,with_out", [(17, False), (289, True), (801, False)])
def test_wrapper_launches_once_with_three_floats_a_row(monkeypatch, length, with_out):
    """``_kernels.spatial_attention_bwd`` hands the C entry the packed QKV,
    dO, dqkv, o (or null) and a scratch of (frames, H, L, 3) fp32, with
    (frames, L, D, 1/8): no (L, L) scratch; it holds the C design to its
    twin and counts one launch a call."""
    lib, scratch = _FakeLibrary(), []
    row_stats = _kernels._row_stats
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "_stream", lambda: 0)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    monkeypatch.setattr(_kernels, "_row_stats", lambda qkv: scratch.append(row_stats(qkv))
                        or scratch[-1])
    frames, heads = 3, 2
    qkv = torch.zeros(frames * length, 3 * 64 * heads, dtype=torch.bfloat16)
    dout = torch.zeros(frames * length, 64 * heads, dtype=torch.bfloat16)
    ops.reset_launch_counts()
    got = _kernels.spatial_attention_bwd(qkv, dout, frames, length, with_out=with_out)
    dqkv, out = got if with_out else (got, None)
    assert dqkv.shape == qkv.shape and (out is None) == (not with_out)
    (args,) = lib.launches
    (stats,) = scratch
    assert stats.dtype == torch.float32 and stats.numel() == frames * heads * length * 3
    assert args[:5] == (qkv.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
                        out.data_ptr() if with_out else None, stats.data_ptr())
    assert args[5:9] == (frames, length, 64 * heads, 0.125)
    assert ("aim_spatial_bwd_design", length) in _kernels._designs_held
    assert _kernels.spatial_attention_bwd.launches == 1
    ops.reset_launch_counts()
    assert _kernels.spatial_attention_bwd.launches == 0


@pytest.mark.parametrize("length", [197, 769])
def test_wrapper_holds_the_c_design_to_its_twin(monkeypatch, length):
    branch, smem = ops.spatial_bwd_design(length)
    other = "streamed" if branch == "staged" else "staged"
    for wrong in ((branch, smem + 16), (other, smem)):
        monkeypatch.setattr(_kernels, "_designs_held", set())
        monkeypatch.setattr(_kernels, "library", lambda w=wrong: _FakeLibrary(w))
        with pytest.raises(RuntimeError):
            _kernels._hold_design("aim_spatial_bwd_design", length)
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary())
    _kernels._hold_design("aim_spatial_bwd_design", length)
    assert ("aim_spatial_bwd_design", length) in _kernels._designs_held


@pytest.mark.parametrize("length,branch", [
    (1, "staged"), (17, "staged"), (197, "staged"), (289, "staged"), (768, "staged"),
    (769, "streamed"), (801, "streamed"), (5000, "streamed")])
def test_spatial_bwd_design_branch_points(length, branch):
    got, smem = ops.spatial_bwd_design(length)
    assert got == branch
    if branch == "staged":  # Q, dO and their statistics, padded to 16 rows
        assert smem == -(-length // 16) * 16 * (2 * ROW_BYTES + STAT_BYTES)
    else:  # two ring slots of 64 rows
        assert smem == 2 * 64 * (2 * ROW_BYTES + STAT_BYTES)


def test_spatial_bwd_design_fits_one_block_and_holds_its_rows():
    for length in range(1, 1200):
        branch, smem = ops.spatial_bwd_design(length)
        assert 0 < smem <= SMEM_MAX, (length, smem)
        if branch == "staged":
            assert smem >= length * (2 * ROW_BYTES + STAT_BYTES)
    with pytest.raises(ValueError):
        ops.spatial_bwd_design(0)


# ---------------------------------------------------------------------------
# the plain core against float64, and the plain block against Pallas


def _float64_grads(q, k, v, do):
    q, k, v, do = (t.double() for t in (q, k, v, do))
    p = torch.softmax(q @ k.transpose(-1, -2) / 8, dim=-1)
    dp = do @ v.transpose(-1, -2)
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return ds @ k / 8, ds.transpose(-1, -2) @ q / 8, p.transpose(-1, -2) @ do


@pytest.mark.parametrize("length", [17, 289, 768, 769, 801])
def test_plain_backward_core_against_float64(length):
    """``spatial_core_bwd_plain`` (2 frames, 2 heads, bf16) against the
    attention gradients in float64 on the same bf16 q, k, v and dO, at the
    design's branch points and the lengths the card tests hold."""
    frames, heads, d = 2, 2, 128
    rng = np.random.default_rng(1300 + length)
    qkv = torch.from_numpy(rng.standard_normal((frames * length, 3 * d))).to(torch.bfloat16)
    do = torch.from_numpy(rng.standard_normal((frames * length, d))).to(torch.bfloat16)
    got = spatial_core_bwd_plain(qkv, do, frames, length, heads).double()
    heads_of = lambda t: t.view(frames, length, heads, 64).transpose(1, 2)  # noqa: E731
    want = _float64_grads(*(heads_of(t) for t in (*qkv.split(d, -1), do)))
    for i, (name, w) in enumerate(zip(("dq", "dk", "dv"), want)):
        w = w.transpose(1, 2).reshape(frames * length, d)
        err = (got[:, i * d:(i + 1) * d] - w).abs()
        assert err.max() <= 8e-3 * w.abs().max(), (name, err.max() / w.abs().max())
        assert err.mean() <= 4e-3 * w.abs().mean(), (name, err.mean() / w.abs().mean())


def _block_case(seed, length, frames=2, d=128):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((frames, length, d)).astype(np.float32)
    wqkv, bqkv, wout, bout = ((0.08 * rng.standard_normal(s)).astype(np.float32)
                              for s in ((d, 3 * d), (3 * d,), (d, d), (d,)))
    g = rng.standard_normal(x.shape).astype(np.float32)
    jargs = [jnp.asarray(a).astype(jnp.bfloat16) for a in (x, wqkv, bqkv, wout, bout)]
    targs = [torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16)
             for a in (x, wqkv.T, bqkv, wout.T, bout)]
    return jargs, targs, jnp.asarray(g).astype(jnp.bfloat16), torch.from_numpy(g).to(torch.bfloat16)


def _close(name, got, want):
    """The bf16 bounds of ``tests/test_torch_ops.py``, their absolute terms
    scaled by the tensor's magnitude past 1: a weight cotangent (|ref| up to
    ~80) sums 578 rows of products with dqkv, whose elements may lie a bf16
    ulp apart, so its gap grows with its scale (measured at L = 289:
    dWqkv max 0.0625 of max|ref| 11.8, mean 1.4e-4 of mean|ref| 1.8;
    out and dx, |ref| < 1, max 2.0e-3 and mean 5.6e-6)."""
    got = got.detach().float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32)).reshape(got.shape)
    scale, mean_scale = max(1.0, np.abs(want).max()), max(1.0, np.abs(want).mean())
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL * scale, err_msg=name)
    assert np.abs(got - want).mean() <= BF16_MEAN_TOL * mean_scale, name


def test_plain_block_matches_pallas_past_288_tokens():
    """At L = 289 (past the former bound): ``fused_qkv_attention_plain``
    against the Pallas forward, and ``fused_attention_block_plain``'s
    backward (dx and every weight cotangent) against ``jax.vjp`` of the JAX
    ``fused_attention_block``, interpret mode."""
    jargs, targs, jg, tg = _block_case(1310, 289)
    with pltpu.force_tpu_interpret_mode():
        want_out = jax_ops.fused_qkv_attention(*jargs, 2)
        out, vjp = jax.vjp(lambda *a: jax_ops.fused_attention_block(*a, 2), *jargs)
        want = vjp(jg)
    _close("out", ops.fused_qkv_attention_plain(*targs, 2), want_out)
    _close("out (vjp)", ops.fused_qkv_attention_plain(*targs, 2), out)
    leaves = [t.clone().requires_grad_() for t in targs]
    ops.fused_attention_block_plain(*leaves, 2).backward(tg)
    for name, leaf, w in zip(("dx", "dWqkv", "dbqkv", "dWout", "dbout"), leaves, want):
        w = np.asarray(jnp.asarray(w, jnp.float32))
        _close(name, leaf.grad, w.T if w.ndim == 2 else w)
