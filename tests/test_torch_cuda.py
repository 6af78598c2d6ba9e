"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. This file
imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)

Shapes are small but cover what the kernels must mask: a token count that
is not a multiple of 16 or 64, a row count that is not a multiple of 128,
adapter widths that are not a multiple of the 128-wide GEMM tile, and the
ViT-L geometry (257 tokens, 16 heads, T=32).

Past LONG_CLIP_T = 32 frames the temporal forwards run the segment core,
checked at 33, 48 and 64 frames, and the LN temporal block's backwards
(rows 17, 19, 20) up to 128 frames; every temporal core serves any T, so
the forwards (rows 2, 14, 15, 23) and the backwards (rows 17 to 22) are
also held at 144 and 300 frames, past the former shared-memory bounds.

The spatial backward core (``csrc/spatial_bwd.cu``: a rows and a columns
kernel on mma.sync) is held alone at the model paths' shapes, past the 288
keys the former WMMA core held and on both sides of its staging bound, and
the two mma orientations of its scores bit for bit; the plain spatial block
runs forward and backward at 289 and 801 tokens.

The two temporal backward cores (``csrc/temporal_bwd.cuh``: the full core's
and the segment core's, on mma.sync) and the full temporal forward core
(``csrc/attention.cu``, on mma.sync) are held alone at every branch point
of their designs, both model widths, with two launches bit-equal.

The LN-only and adapter-only attention blocks of ``CLIPAttention``
(rows 5, 6, 7, 10 and 16) are held op by op, row 10 at r = 1, 2, 4 and at
a batch that r does not divide, and through their autograd ops.

The train ops are checked forward and backward (output, dx and the
adapter cotangents), with drop-path gates that hold zeros and 1/keep; the
plain temporal and spatial attention blocks forward and backward (output,
dx, dqkv, o, and through their autograd ops every weight cotangent), the
spatial one at the prompt token's odd length 198 and the temporal one at
the flash variants' single class token per frame. The composition train
step, which ViT-L widths and 32-frame clips take, is checked op by op (the
gated forwards with their u output, the two dX-only backwards) and through
both train ops with the two predicates that pick the design
(``step_whole_cell_fits``, ``tstep_whole_cell_fits``) monkeypatched to the
composition; the whole-step tests patch them the other way so that they go
on holding the whole-step kernels at every geometry.

A batch-2 artifact exported on the card runs through
``run_exported_evaluation`` with its kernels launched, held against the
plain route of the same model.

Tolerance. Kernel and plain version round the same intermediates to bf16
but sum fp32 products in different orders, so single values can land a few
bf16 ulps apart where a rounding flip is amplified. Each is therefore held
against the unrounded result (the plain version run in fp32 throughout):
the kernel's max error may be at most 2x the plain version's plus 1e-2,
and its mean error at most 1.25x plus 1e-5. Kernel and plain version must
also agree to 2e-3 in mean absolute difference.
"""

import importlib

import numpy as np
import pytest
import torch

from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import (
    fused_attention_block, fused_attention_block_plain, fused_joint,
    fused_joint_mlp_rows_bwd, fused_joint_plain, fused_ln_qkv_attention_bwd_dx,
    fused_ln_qkv_attention_bwd_dx_plain, fused_ln_temporal_attention_bwd_dx,
    fused_ln_temporal_attention_bwd_dx_plain, fused_qkv_attention,
    fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain, fused_qkv_attention_plain,
    fused_joint_train_block, fused_joint_train_block_plain, fused_spatial_step,
    fused_spatial_step_gated, fused_spatial_step_plain, fused_spatial_train_step,
    fused_spatial_train_step_plain, fused_step_bwd_dx, fused_temporal_attention,
    fused_temporal_attention_bwd, fused_temporal_attention_bwd_plain,
    fused_temporal_attention_plain, fused_temporal_block, fused_temporal_block_plain,
    fused_temporal_step, fused_temporal_step_bwd_dx, fused_temporal_step_gated,
    fused_temporal_step_plain,
    fused_temporal_train_step, fused_temporal_train_step_plain,
)

pytestmark = pytest.mark.cuda

# the modules, not the functions of the same names that ``ops`` exports
tfqa = importlib.import_module("adapt_image_models_torch.ops.fused_qkv_attention")
tfta = importlib.import_module("adapt_image_models_torch.ops.fused_temporal_attention")

MEAN_TOL = 2e-3


def _force_design(monkeypatch, composition: bool):
    """Both train ops take the composition, or the whole step, at any
    geometry."""
    monkeypatch.setattr(tfqa, "step_whole_cell_fits", lambda *a: not composition)
    monkeypatch.setattr(tfta, "tstep_whole_cell_fits", lambda *a: not composition)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(device, rows, n, d, dh, seed, joint=False):
    g = torch.Generator().manual_seed(seed)

    def r(*shape, s=0.05):
        return (s * torch.randn(*shape, generator=g)).to(torch.bfloat16).to(device)

    x = torch.randn(rows, n, d, generator=g).to(torch.bfloat16).to(device)
    ln_w = (1 + 0.1 * torch.randn(d, generator=g)).to(device)
    ln_b = (0.1 * torch.randn(d, generator=g)).to(device)
    wide = 4 * d if joint else 3 * d
    first = (r(wide, d), r(wide), r(d, wide if joint else d), r(d))
    return x, ln_w, ln_b, first + (r(dh, d), r(dh), r(d, dh), r(d))


def _check(op, plain, x, ln_w, ln_b, weights, *rest):
    """Run ``op`` once on the card and hold it against ``plain``."""
    before = op.launches
    got = op(x, ln_w, ln_b, *weights, *rest).float()
    torch.cuda.synchronize()
    assert op.launches == before + 1
    want = plain(x, ln_w, ln_b, *weights, *rest).float()
    exact = plain(x.float(), ln_w, ln_b, *(w.float() for w in weights), *rest)
    err_k, err_p = (got - exact).abs(), (want - exact).abs()
    assert err_k.max() <= 2 * err_p.max() + 1e-2, (err_k.max(), err_p.max())
    assert err_k.mean() <= 1.25 * err_p.mean() + 1e-5, (err_k.mean(), err_p.mean())
    assert (got - want).abs().mean() < MEAN_TOL


@pytest.mark.parametrize("n,heads", [(37, 2), (197, 12), (257, 16)])
@pytest.mark.parametrize("skip", [True, False])
def test_spatial_kernel_matches_plain(cuda, n, heads, skip):
    x, w, b, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 0)
    _check(fused_spatial_step, fused_spatial_step_plain, x, w, b, ws, heads, skip)


@pytest.mark.parametrize("t,heads", [(4, 2), (8, 12), (32, 2), (32, 16)])
def test_temporal_kernel_matches_plain(cuda, t, heads):
    x, w, b, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 1)
    _check(fused_temporal_step, fused_temporal_step_plain, x, w, b, ws, t, heads, False)


def test_joint_kernel_matches_plain(cuda):
    x, w, b, ws = _args(cuda, 6, 37, 256, 64, 2, joint=True)
    _check(fused_joint, fused_joint_plain, x, w, b, ws, 0.5)


def test_kernels_refuse_what_they_do_not_take(cuda):
    x, w, b, ws = _args(cuda, 4, 37, 128, 32, 3)
    with pytest.raises(ValueError):  # fp32 input
        fused_spatial_step(x.float(), w, b, *ws, 2, True)
    with pytest.raises(ValueError):  # head dim 32
        fused_spatial_step(x, w, b, *ws, 4, True)
    for t in (33, 64):  # past LONG_CLIP_T: the segment core
        xt = x[:1].repeat(2 * t, 1, 1)
        _check(fused_temporal_step, fused_temporal_step_plain, xt, w, b, ws, t, 2, False)
    xt = x[:1].repeat(300, 1, 1)  # one clip past 256 frames: no frame bound
    _check(fused_temporal_step, fused_temporal_step_plain, xt, w, b, ws, 300, 2, False)


def _train_check(fwd_op, plain, bwd_op, x, ln_w, ln_b, weights, gate, *rest, op=None):
    """Run the train op forward and backward once on the card and hold its
    output, dx and adapter cotangents against the plain version's.
    ``fwd_op`` and ``bwd_op`` carry the launch counters of its forward and
    backward; ``op`` is the train op where it is not ``fwd_op``."""
    op = op or fwd_op
    g = torch.Generator().manual_seed(7)
    cot = torch.randn(x.shape, generator=g).to(x.device)

    def run(fn, dtype):
        xx = x.detach().to(dtype).clone().requires_grad_()
        frozen = [w.to(dtype) for w in weights[:4]]
        ad = [w.detach().to(dtype).clone().requires_grad_() for w in weights[4:]]
        out = fn(xx, ln_w, ln_b, *frozen, *ad, gate, *rest)
        out.backward(cot.to(dtype))
        return [t.float() for t in (out.detach(), xx.grad, *(w.grad for w in ad))]

    before = (fwd_op.launches, bwd_op.launches)
    got = run(op, torch.bfloat16)
    torch.cuda.synchronize()
    assert (fwd_op.launches, bwd_op.launches) == (before[0] + 1, before[1] + 1)
    want = run(plain, torch.bfloat16)
    exact = run(plain, torch.float32)
    for name, k, p, e in zip(("out", "dx", "dW1", "db1", "dW2", "db2"), got, want, exact):
        err_k, err_p = (k - e).abs(), (p - e).abs()
        scale = e.abs().mean()
        assert err_k.max() <= 2 * err_p.max() + 1e-2 * max(1.0, e.abs().max()), (
            name, err_k.max(), err_p.max())
        assert err_k.mean() <= 1.25 * err_p.mean() + 1e-5 * max(1.0, scale), (
            name, err_k.mean(), err_p.mean())


def _gate(device, rows):
    return torch.where(torch.arange(rows) % 3 == 1, 0.0, 1 / 0.9).to(device)


@pytest.mark.parametrize("n,heads", [(37, 2), (197, 12), (257, 16)])
def test_spatial_train_kernels_match_plain(cuda, n, heads, monkeypatch):
    _force_design(monkeypatch, composition=False)
    x, w, b, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 4)
    _train_check(fused_spatial_train_step, fused_spatial_train_step_plain,
                 fused_step_bwd_dx, x, w, b, ws, None, heads, True)


def test_gated_whole_step_counts_under_the_gated_forward(cuda, monkeypatch):
    """A spatial whole step that is given a gate launches the gated forward
    kernel and counts there, as ``ops.train_ops(spatial_gate=True)`` says."""
    _force_design(monkeypatch, composition=False)
    x, w, b, ws = _args(cuda, 6, 197, 768, 192, 21)
    names = ops.train_ops(1, 8, 197, 768, spatial_gate=True)[2:4]
    assert names == ("fused_spatial_step_gated", "fused_step_bwd_dx")
    before = fused_spatial_train_step.launches
    _train_check(fused_spatial_step_gated, fused_spatial_train_step_plain,
                 fused_step_bwd_dx, x, w, b, ws, _gate(cuda, 6), 12, True,
                 op=fused_spatial_train_step)
    assert fused_spatial_train_step.launches == before


@pytest.mark.parametrize("t,heads", [(4, 2), (8, 12), (32, 2), (32, 16)])
def test_temporal_train_kernels_match_plain(cuda, t, heads, monkeypatch):
    _force_design(monkeypatch, composition=False)
    x, w, b, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 5)
    _train_check(fused_temporal_train_step, fused_temporal_train_step_plain,
                 fused_temporal_step_bwd_dx, x, w, b, ws, _gate(cuda, 2 * t), t,
                 heads, False)


@pytest.mark.parametrize("n,heads,gated", [(37, 2, True), (197, 12, False),
                                           (257, 16, True)])
def test_spatial_composition_kernels_match_plain(cuda, n, heads, gated, monkeypatch):
    """The spatial train op through the composition: the gated forward that
    saves u, and the dX-only backward."""
    _force_design(monkeypatch, composition=True)
    x, w, b, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 14)
    before = fused_step_bwd_dx.launches
    _train_check(fused_spatial_step_gated, fused_spatial_train_step_plain,
                 fused_ln_qkv_attention_bwd_dx, x, w, b, ws,
                 _gate(cuda, 6) if gated else None, heads, True,
                 op=fused_spatial_train_step)
    assert fused_step_bwd_dx.launches == before


@pytest.mark.parametrize("t,heads", [(4, 2), (8, 12), (32, 2), (32, 16)])
def test_temporal_composition_kernels_match_plain(cuda, t, heads, monkeypatch):
    _force_design(monkeypatch, composition=True)
    x, w, b, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 15)
    _train_check(fused_temporal_train_step, fused_temporal_train_step_plain,
                 fused_ln_temporal_attention_bwd_dx, x, w, b, ws, _gate(cuda, 2 * t), t,
                 heads, False)


@pytest.mark.parametrize("kind,t,n,heads", [
    ("spatial", 1, 37, 2), ("spatial", 1, 197, 12), ("spatial", 1, 257, 16),
    ("temporal", 8, 37, 12), ("temporal", 32, 37, 16), ("temporal", 32, 257, 16)])
def test_gated_forward_with_u_matches_plain(cuda, kind, t, n, heads):
    """Out and u of the gated forwards; a zero gate keeps its row."""
    rows = 6 if kind == "spatial" else 2 * t
    x, w, b, ws = _args(cuda, rows, n, 64 * heads, 16 * heads, 16)
    gate = _gate(cuda, rows)
    if kind == "spatial":
        op, counter, rest = fused_spatial_step_gated, fused_spatial_step_gated, (heads, True)
        plain = fused_spatial_step_plain
    else:
        op, counter, rest = fused_temporal_step_gated, fused_temporal_train_step, (
            t, heads, False)
        plain = fused_temporal_step_plain
    before = counter.launches
    got = op(x, gate, w, b, *ws, *rest, emit_u=True)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    want = plain(x, w, b, *ws, *rest, gate, True)
    exact = plain(x.float(), w, b, *(a.float() for a in ws), *rest, gate, True)
    for name, k, p, e in zip(("out", "u"), got, want, exact):
        _held(name, k, p, e)
        assert (k.float() - p.float()).abs().mean() < MEAN_TOL
    assert torch.equal(got[0][1], x[1])
    assert torch.equal(op(x, gate, w, b, *ws, *rest), got[0])  # u changes no bit of out


@pytest.mark.parametrize("kind,t,n,heads", [
    ("spatial", 1, 37, 2), ("spatial", 1, 197, 12), ("spatial", 1, 257, 16),
    ("temporal", 8, 37, 12), ("temporal", 32, 37, 16), ("temporal", 32, 257, 16)])
def test_bwd_dx_kernels_match_plain(cuda, kind, t, n, heads):
    """The dX-only backwards at ViT-B and ViT-L geometry."""
    rows = 6 if kind == "spatial" else 2 * t
    x, w, b, ws = _args(cuda, rows, n, 64 * heads, 16 * heads, 17)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(18)).to(x)
    if kind == "spatial":
        op, plain, rest = (fused_ln_qkv_attention_bwd_dx,
                           fused_ln_qkv_attention_bwd_dx_plain, (heads,))
    else:
        op, plain, rest = (fused_ln_temporal_attention_bwd_dx,
                           fused_ln_temporal_attention_bwd_dx_plain, (t, heads))
    before = op.launches
    got = op(x, w, b, *ws[:3], g, *rest)
    torch.cuda.synchronize()
    assert op.launches == before + 1 and got.dtype == x.dtype
    _held("dx", got, plain(x, w, b, *ws[:3], g, *rest),
          plain(x.float(), w, b, *(a.float() for a in ws[:3]), g.float(), *rest))


def test_composition_ops_refuse_what_they_do_not_take(cuda):
    x, w, b, ws = _args(cuda, 4, 37, 128, 32, 19)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(20)).to(x)
    with pytest.raises(ValueError):  # fp32 input
        fused_ln_qkv_attention_bwd_dx(x.float(), w, b, *ws[:3], g.float(), 2)
    with pytest.raises(ValueError):  # a cotangent unlike x
        fused_ln_temporal_attention_bwd_dx(x, w, b, *ws[:3], g.float(), 2, 2)
    for t in (33, 64):  # past LONG_CLIP_T, still on the full core
        xt, gt = x[:1].repeat(2 * t, 1, 1), g[:1].repeat(2 * t, 1, 1)
        _held("dx", fused_ln_temporal_attention_bwd_dx(xt, w, b, *ws[:3], gt, t, 2),
              fused_ln_temporal_attention_bwd_dx_plain(xt, w, b, *ws[:3], gt, t, 2),
              fused_ln_temporal_attention_bwd_dx_plain(
                  xt.float(), w, b, *(a.float() for a in ws[:3]), gt.float(), t, 2))
    xt, gt = x[:1].repeat(144, 1, 1), g[:1].repeat(144, 1, 1)  # no frame bound
    _held("dx", fused_ln_temporal_attention_bwd_dx(xt, w, b, *ws[:3], gt, 144, 2),
          fused_ln_temporal_attention_bwd_dx_plain(xt, w, b, *ws[:3], gt, 144, 2),
          fused_ln_temporal_attention_bwd_dx_plain(
              xt.float(), w, b, *(a.float() for a in ws[:3]), gt.float(), 144, 2))
    with pytest.raises(ValueError):  # a gate on the host
        fused_spatial_step_gated(x, torch.ones(4), w, b, *ws, 2, True)


def test_joint_train_kernels_match_plain(cuda):
    x, w, b, ws = _args(cuda, 6, 37, 256, 64, 6, joint=True)
    _train_check(fused_joint_train_block, fused_joint_train_block_plain,
                 fused_joint_mlp_rows_bwd, x, w, b, ws, _gate(cuda, 6 * 37), 0.5)


def _held(name, k, p, e):
    """Kernel result ``k`` and plain result ``p`` against the unrounded ``e``."""
    k, p, e = k.float(), p.float(), e.float()
    err_k, err_p = (k - e).abs(), (p - e).abs()
    assert err_k.max() <= 2 * err_p.max() + 1e-2 * max(1.0, e.abs().max()), (
        name, err_k.max(), err_p.max())
    assert err_k.mean() <= 1.25 * err_p.mean() + 1e-5 * max(1.0, e.abs().mean()), (
        name, err_k.mean(), err_p.mean())


def _block_check(fwd, bwd, fwd_plain, bwd_plain, block, block_plain, x, wts, g, *rest):
    """A plain attention block, forward and backward (dx, dqkv, o), and
    through its autograd op dx and every weight cotangent, on the card
    against the plain version and the unrounded result."""
    f32 = [w.float() for w in wts]
    before = (fwd.launches, bwd.launches)
    out = fwd(x, *wts, *rest)
    got = bwd(x, *wts[:3], g, *rest)
    torch.cuda.synchronize()
    assert (fwd.launches, bwd.launches) == (before[0] + 1, before[1] + 1)
    _held("out", out, fwd_plain(x, *wts, *rest), fwd_plain(x.float(), *f32, *rest))
    want = bwd_plain(x, *wts[:3], g, *rest)
    exact = bwd_plain(x.float(), *f32[:3], g.float(), *rest)
    for name, k, p, e in zip(("dx", "dqkv", "o"), got, want, exact):
        _held(name, k, p, e)

    def grads(fn, dtype):
        leaves = [a.detach().to(dtype).clone().requires_grad_() for a in (x, *wts)]
        fn(*leaves, *rest).backward(g.to(dtype))
        return [a.grad for a in leaves]

    for name, k, p, e in zip(("dx", "dWqkv", "dbqkv", "dWout", "dbout"),
                             grads(block, torch.bfloat16),
                             grads(block_plain, torch.bfloat16),
                             grads(block_plain, torch.float32)):
        _held(name, k, p, e)


@pytest.mark.parametrize("t,heads,n", [(4, 2, 37), (8, 12, 37), (16, 12, 37), (32, 16, 37),
                                       (32, 12, 1)])
def test_temporal_block_kernels_match_plain(cuda, t, heads, n):
    """The plain temporal attention block; n=1 is the flash variants' class
    token, attending across 32 frames."""
    x, _, _, ws = _args(cuda, 2 * t, n, 64 * heads, 16 * heads, 8)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(9)).to(x)
    _block_check(fused_temporal_attention, fused_temporal_attention_bwd,
                 fused_temporal_attention_plain, fused_temporal_attention_bwd_plain,
                 fused_temporal_block, fused_temporal_block_plain, x, ws[:4], g, t, heads)


@pytest.mark.parametrize("n,heads", [(17, 2), (197, 12), (198, 12), (257, 16), (800, 12)])
def test_spatial_block_kernels_match_plain(cuda, n, heads):
    """The plain spatial attention block; 198 is ViT-B/16's tokens with the
    prompt token, 800 AIM_FLASH_DUAL's side stream (16 prompt and 16 x 49
    window keys at the shipped (16, 7, 7)): the flash core's staged branch
    at its limit and the spatial backward core's streamed ring (rows 4 and
    8)."""
    x, _, _, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 11)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(12)).to(x)
    _block_check(fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_plain,
                 fused_qkv_attention_bwd_plain, fused_attention_block,
                 fused_attention_block_plain, x, ws[:4], g, heads)


def test_spatial_block_refuses_what_it_does_not_take(cuda):
    """No token bound: at L = 289 and 801 (past the backward core's
    staging bound) the block runs forward and backward and is held to its
    plain version; what the kernels do not take still raises."""
    for n in (289, 801):
        x, _, _, ws = _args(cuda, 2, n, 128, 32, 13)
        g = torch.randn(x.shape, generator=torch.Generator().manual_seed(n)).to(x)
        _block_check(fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_plain,
                     fused_qkv_attention_bwd_plain, fused_attention_block,
                     fused_attention_block_plain, x, ws[:4], g, 2)
    with pytest.raises(ValueError):  # fp32 input
        fused_qkv_attention(x[:, :17].float().contiguous(), *ws[:4], 2)
    with pytest.raises(ValueError):  # a cotangent unlike x
        fused_qkv_attention_bwd(x[:, :17].contiguous(), *ws[:3], x[:, :17].float(), 2)


def test_temporal_block_refuses_what_it_does_not_take(cuda):
    x, _, _, ws = _args(cuda, 4, 37, 128, 32, 10)
    with pytest.raises(ValueError):  # fp32 input
        fused_temporal_attention(x.float(), *ws[:4], 2, 2)
    with pytest.raises(ValueError):  # an fp32 weight
        fused_temporal_attention(x, ws[0].float(), *ws[1:4], 2, 2)
    for t in (33, 64):  # past LONG_CLIP_T: the segment core
        xt = x[:1].repeat(2 * t, 1, 1)
        _held("out", fused_temporal_attention(xt, *ws[:4], t, 2),
              fused_temporal_attention_plain(xt, *ws[:4], t, 2),
              fused_temporal_attention_plain(xt.float(), *(a.float() for a in ws[:4]),
                                             t, 2))
    xt = x[:1].repeat(300, 1, 1)  # one clip past 256 frames: no frame bound
    _held("out", fused_temporal_attention(xt, *ws[:4], 300, 2),
          fused_temporal_attention_plain(xt, *ws[:4], 300, 2),
          fused_temporal_attention_plain(xt.float(), *(a.float() for a in ws[:4]), 300, 2))
    with pytest.raises(ValueError):  # a cotangent unlike x
        fused_temporal_attention_bwd(x, *ws[:3], x.float(), 2, 2)


@pytest.mark.parametrize("t,heads", [(33, 2), (48, 12), (64, 16)])
def test_long_clip_forwards_match_plain(cuda, t, heads):
    """Past LONG_CLIP_T every temporal forward runs the segment core
    (``csrc/temporal_segment.cu``): the eval step (row 2), the plain and the
    LN block (rows 14, 15) and the gated train forward with u (row 23), at
    2 clips, against their plain versions."""
    x, w, b, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 23)
    _check(fused_temporal_step, fused_temporal_step_plain, x, w, b, ws, t, heads, True)
    f32 = [a.float() for a in ws]
    for op, plain, args, args32 in (
            (fused_temporal_attention, fused_temporal_attention_plain, (x, *ws[:4]),
             (x.float(), *f32[:4])),
            (ops.fused_ln_temporal_attention, ops.fused_ln_temporal_attention_plain,
             (x, w, b, *ws[:4]), (x.float(), w, b, *f32[:4]))):
        before = op.launches
        got = op(*args, t, heads)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        _held(op.__name__, got, plain(*args, t, heads), plain(*args32, t, heads))
    gate = _gate(cuda, 2 * t)
    got = fused_temporal_step_gated(x, gate, w, b, *ws, t, heads, False, emit_u=True)
    want = fused_temporal_step_plain(x, w, b, *ws, t, heads, False, gate, True)
    exact = fused_temporal_step_plain(x.float(), w, b, *f32, t, heads, False, gate, True)
    for name, k, p, e in zip(("out", "u"), got, want, exact):
        _held(name, k, p, e)


@pytest.mark.parametrize("t,heads,n", [(8, 12, 37), (24, 12, 37), (33, 2, 37),
                                       (64, 12, 37), (64, 16, 257), (128, 2, 9)])
def test_ln_block_backwards_match_plain(cuda, t, heads, n):
    """The LN block's backwards: row 17 (the full core) and row 19 (the
    segment core), each (dx, dqkv, dy, y, o), and row 20 (the segment core's
    dX only), at ViT-B and ViT-L widths and up to 128 frames."""
    x, w, b, ws = _args(cuda, 2 * t if t < 128 else t, n, 64 * heads, 16 * heads, 24)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(25)).to(x)
    args, args32 = (x, w, b, *ws[:3], g), (x.float(), w, b, *(a.float() for a in ws[:3]),
                                          g.float())
    for op, plain in ((ops.fused_ln_temporal_attention_bwd,
                       ops.fused_ln_temporal_attention_bwd_plain),
                      (ops.fused_ln_temporal_attention_bwd_segment,
                       ops.fused_ln_temporal_attention_bwd_segment_plain),
                      (ops.fused_ln_temporal_attention_bwd_dx_segment,
                       ops.fused_ln_temporal_attention_bwd_dx_segment_plain)):
        before = op.launches
        got = op(*args, t, heads)
        torch.cuda.synchronize()
        assert op.launches == before + 1
        want, exact = plain(*args, t, heads), plain(*args32, t, heads)
        if isinstance(got, torch.Tensor):
            got, want, exact = (got,), (want,), (exact,)
        for name, k, p, e in zip(("dx", "dqkv", "dy", "y", "o"), got, want, exact):
            _held(f"{op.__name__} {name}", k, p, e)


@pytest.mark.parametrize("t,frozen", [(8, False), (24, False), (64, False), (8, True),
                                      (64, True)])
def test_ln_block_autograd_matches_plain(cuda, t, frozen):
    """``fused_ln_temporal_block`` in the three designs of
    ``ln_block_bwd_design`` at D = 768 (T = 8: row 17; 24: row 19; 64: the
    XLA reference's vector-Jacobian product) and
    ``fused_ln_temporal_block_frozen`` (rows 21, 20): output, dx and every
    weight and LN cotangent against the plain op's."""
    x, w, b, ws = _args(cuda, 2 * t, 37, 768, 192, 26)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(27)).to(x)
    block = ops.fused_ln_temporal_block_frozen if frozen else ops.fused_ln_temporal_block
    plain = (ops.fused_ln_temporal_block_frozen_plain if frozen
             else ops.fused_ln_temporal_block_plain)

    def run(fn, dtype):
        leaves = [a.detach().to(dtype if a.dtype == torch.bfloat16 else a.dtype)
                  .clone().requires_grad_() for a in (x, w, b, *ws[:4])]
        out = fn(*leaves, t, 12)
        out.backward(g.to(dtype))
        return [out.detach()] + [a.grad for a in leaves]

    names = ("out", "dx", "dgamma", "dbeta", "dWqkv", "dbqkv", "dWout", "dbout")
    for name, k, p, e in zip(names, run(block, torch.bfloat16), run(plain, torch.bfloat16),
                             run(plain, torch.float32)):
        if frozen and name not in ("out", "dx"):
            assert not k.any(), name
        else:
            _held(name, k, p, e)


def _projection_views(device, b, heads, n, seed):
    """q, k, v as the model hands them to the flash core: (B, H, L, 64)
    views of one (B, L, 3·H·64) bf16 projection."""
    x = torch.randn(b, n, 3 * heads * 64, generator=torch.Generator().manual_seed(seed))
    x = x.to(device, torch.bfloat16)
    return [t.reshape(b, n, heads, 64).transpose(1, 2) for t in x.split(heads * 64, -1)]


@pytest.mark.parametrize("b,heads,n", [(2, 2, 1), (3, 12, 4), (2, 12, 32), (2, 2, 37),
                                       (4, 12, 197), (2, 16, 257), (1, 2, 800)])
def test_flash_core_matches_plain(cuda, b, heads, n):
    """The flash core (PERF.md row 13) at the class token's T, odd and
    ViT lengths and past the spatial core's 288 keys, read through the
    projection's strides and once from contiguous copies; one launch each."""
    q, k, v = _projection_views(cuda, b, heads, n, 20 + n)
    before = ops.flash_attention_core.launches
    out = ops.flash_attention_core(q, k, v)
    flat = ops.flash_attention_core(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert ops.flash_attention_core.launches == before + 2
    assert out.shape == q.shape and torch.equal(out, flat)
    exact = ops.flash_attention_core_plain(q.float(), k.float(), v.float())
    _held("out", out, ops.flash_attention_core_plain(q, k, v), exact)
    assert (out.float() - ops.flash_attention_core_plain(q, k, v).float()).abs().mean() < MEAN_TOL


def test_fused_attention_backward_is_the_xla_cores(cuda):
    """``fused_attention``: the kernel forward, and the XLA core's gradient
    (the same framework ops as ``fused_attention_plain``'s backward)."""
    leaves = [t.detach().requires_grad_() for t in _projection_views(cuda, 2, 12, 50, 30)]
    g = torch.randn(leaves[0].shape, generator=torch.Generator().manual_seed(31)).to(leaves[0])
    ops.fused_attention(*leaves).backward(g)
    got = [t.grad for t in leaves]
    for t in leaves:
        t.grad = None
    ops.fused_attention_plain(*leaves).backward(g)
    for a, t in zip(got, leaves):
        assert torch.equal(a, t.grad)


def test_flash_core_refuses_what_it_does_not_take(cuda):
    q, k, v = _projection_views(cuda, 2, 2, 37, 32)
    with pytest.raises(ValueError):  # fp32
        ops.flash_attention_core(q.float(), k.float(), v.float())
    with pytest.raises(ValueError):  # head dim 32
        ops.flash_attention_core(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(ValueError):  # q and k of other lengths
        ops.flash_attention_core(q, k[:, :, :5], v[:, :, :5])


@pytest.mark.parametrize("t", [144, 300])
def test_temporal_cores_past_the_former_frame_bounds(cuda, t):
    """One clip of T = 144 and 300 frames (the backward cores staged at most
    141 / 134 frames, the forward cores 256): the forwards of rows 2, 14,
    15 and 23 (with u) and the backwards of rows 17 to 22, each against
    its plain version and the unrounded result."""
    x, w, b, ws = _args(cuda, t, 9, 128, 32, 40)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(41)).to(x)
    f32 = [a.float() for a in ws]
    _check(fused_temporal_step, fused_temporal_step_plain, x, w, b, ws, t, 2, True)
    gate = _gate(cuda, t)
    got = fused_temporal_step_gated(x, gate, w, b, *ws, t, 2, False, emit_u=True)
    for name, k, p, e in zip(
            ("out", "u"), got, fused_temporal_step_plain(x, w, b, *ws, t, 2, False, gate, True),
            fused_temporal_step_plain(x.float(), w, b, *f32, t, 2, False, gate, True)):
        _held(name, k, p, e)
    for op, args, args32 in (
            (ops.fused_temporal_attention, (x, *ws[:4]), (x.float(), *f32[:4])),
            (ops.fused_ln_temporal_attention, (x, w, b, *ws[:4]), (x.float(), w, b, *f32[:4])),
            (ops.fused_temporal_attention_bwd, (x, *ws[:3], g), (x.float(), *f32[:3], g.float())),
            (ops.fused_ln_temporal_attention_bwd, (x, w, b, *ws[:3], g),
             (x.float(), w, b, *f32[:3], g.float())),
            (ops.fused_ln_temporal_attention_bwd_segment, (x, w, b, *ws[:3], g),
             (x.float(), w, b, *f32[:3], g.float())),
            (ops.fused_ln_temporal_attention_bwd_dx_segment, (x, w, b, *ws[:3], g),
             (x.float(), w, b, *f32[:3], g.float())),
            (ops.fused_ln_temporal_attention_bwd_dx, (x, w, b, *ws[:3], g),
             (x.float(), w, b, *f32[:3], g.float())),
            (ops.fused_temporal_step_bwd_dx, (x, gate, w, b, *ws, g),
             (x.float(), gate, w, b, *f32, g.float()))):
        plain = getattr(ops, op.__name__ + "_plain")
        rest = (t, 2, False) if op is ops.fused_temporal_step_bwd_dx else (t, 2)
        before = op.launches
        got = op(*args, *rest)
        torch.cuda.synchronize()
        assert op.launches == before + 1, op.__name__
        want, exact = plain(*args, *rest), plain(*args32, *rest)
        if isinstance(got, torch.Tensor):
            got, want, exact = (got,), (want,), (exact,)
        if op is ops.fused_temporal_step_bwd_dx:  # (dx, u, dpre, a, db)
            got, want, exact = got[:4], want[:4], exact[:4]
        for k, (a, p, e) in enumerate(zip(got, want, exact)):
            _held(f"{op.__name__} {k}", a, p, e)


@pytest.mark.parametrize("n,heads", [(17, 2), (197, 12), (257, 16)])
def test_spatial_ln_and_adapter_ops_match_plain(cuda, n, heads):
    """Rows 5 (the LN block forward), 7 (its backward: dx, dqkv, dy, y, o),
    10 (row 5 over groups of r samples, r = 1, 2, 4 and 4 on a batch of 6,
    bit-equal to row 5) and 6 (the adapter block, skip on and off)."""
    x, w, b, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 42)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(43)).to(x)
    f32 = [a.float() for a in ws]
    ln_args, ln32 = (x, w, b, *ws[:4]), (x.float(), w, b, *f32[:4])
    before = ops.fused_ln_qkv_attention.launches
    out = ops.fused_ln_qkv_attention(*ln_args, heads)
    torch.cuda.synchronize()
    assert ops.fused_ln_qkv_attention.launches == before + 1
    _held("row 5", out, ops.fused_ln_qkv_attention_plain(*ln_args, heads),
          ops.fused_ln_qkv_attention_plain(*ln32, heads))
    for r in (1, 2, 4):
        got = ops.fused_ln_qkv_attention_r(*ln_args, heads, r)
        torch.cuda.synchronize()
        assert torch.equal(got, out), r
    before = ops.fused_ln_qkv_attention_bwd.launches
    got = ops.fused_ln_qkv_attention_bwd(x, w, b, *ws[:3], g, heads)
    torch.cuda.synchronize()
    assert ops.fused_ln_qkv_attention_bwd.launches == before + 1
    for name, k, p, e in zip(("dx", "dqkv", "dy", "y", "o"), got,
                             ops.fused_ln_qkv_attention_bwd_plain(x, w, b, *ws[:3], g, heads),
                             ops.fused_ln_qkv_attention_bwd_plain(
                                 x.float(), w, b, *f32[:3], g.float(), heads)):
        _held(f"row 7 {name}", k, p, e)
    for skip in (True, False):
        before = ops.fused_qkv_attention_adapter.launches
        got = ops.fused_qkv_attention_adapter(x, *ws, heads, skip)
        torch.cuda.synchronize()
        assert ops.fused_qkv_attention_adapter.launches == before + 1
        _held(f"row 6 skip={skip}", got,
              ops.fused_qkv_attention_adapter_plain(x, *ws, heads, skip),
              ops.fused_qkv_attention_adapter_plain(x.float(), *f32, heads, skip))


@pytest.mark.parametrize("t,heads", [(8, 12), (33, 2), (64, 16)])
def test_temporal_adapter_op_matches_plain(cuda, t, heads):
    """Row 16, the temporal adapter block's forward, on the full core (T =
    8) and the segment core (33, 64), skip on and off."""
    x, _, _, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 44)
    f32 = [a.float() for a in ws]
    for skip in (True, False):
        before = ops.fused_temporal_attention_adapter.launches
        got = ops.fused_temporal_attention_adapter(x, *ws, t, heads, skip)
        torch.cuda.synchronize()
        assert ops.fused_temporal_attention_adapter.launches == before + 1
        _held(f"row 16 skip={skip}", got,
              ops.fused_temporal_attention_adapter_plain(x, *ws, t, heads, skip),
              ops.fused_temporal_attention_adapter_plain(x.float(), *f32, t, heads, skip))


@pytest.mark.parametrize("block,n,heads", [
    ("ln", 197, 12), ("ln", 257, 16), ("ln_frozen", 197, 12), ("adapter", 197, 12),
    ("temporal_adapter", 37, 12)])
def test_layer_blocks_autograd_match_plain(cuda, block, n, heads):
    """The four autograd ops of ``CLIPAttention``'s LN-only and adapter-only
    calls (the LN block at ViT-B takes row 7, at ViT-L the reference's
    vector-Jacobian product; the frozen one row 9; the adapter blocks the
    reference's) against their plain versions: output, dx and every weight
    cotangent, the launches as ``ops.layer_block_ops`` names them."""
    t = 8
    x, w, b, ws = _args(cuda, 2 * t if block == "temporal_adapter" else 4, n, 64 * heads,
                        16 * heads, 45)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(46)).to(x)
    if block in ("ln", "ln_frozen"):
        op = (ops.fused_ln_attention_block_frozen if block == "ln_frozen"
              else ops.fused_ln_attention_block)
        inputs, rest = (x, w, b, *ws[:4]), (heads,)
    elif block == "adapter":
        op, inputs, rest = ops.fused_attention_adapter_block, (x, *ws), (heads, True)
    else:
        op, inputs, rest = ops.fused_temporal_adapter_block, (x, *ws), (t, heads, False)
    plain = getattr(ops, op.__name__ + "_plain")

    def run(fn, dtype):
        leaves = [a.detach().to(dtype if a.dtype == torch.bfloat16 else a.dtype)
                  .clone().requires_grad_() for a in inputs]
        out = fn(*leaves, *rest)
        out.backward(g.to(dtype))
        return [out.detach()] + [a.grad for a in leaves]

    ops.reset_launch_counts()
    got = run(op, torch.bfloat16)
    torch.cuda.synchronize()
    fwd, bwd = ops.layer_block_ops(block, n, 64 * heads)
    assert ops.launch_counts() == {k: int(k == fwd) + int(k == bwd)
                                   for k in ops.KERNEL_OPS}, ops.launch_counts()
    for k, (a, p, e) in enumerate(zip(got, run(plain, torch.bfloat16),
                                      run(plain, torch.float32))):
        if block == "ln_frozen" and k > 1:
            assert not a.any(), k
        else:
            _held(f"{block} {k}", a, p, e)


# ---------------------------------------------------------------------------
# the segment forward core and the flash core at their branch points
# (ops.segment_fwd_design, ops.flash_fwd_design)


@pytest.mark.parametrize("frames", [33, 64, 65, 128, 129, 300, 801])
def test_segment_core_branches_match_plain(cuda, frames):
    """The segment forward core at each branch point (registers to 64 and
    to 128 frames, three passes over staged rows, past 800 the ring), 1
    clip of 3 tokens, 2 heads: against its plain version and the unrounded
    result; two launches bit-equal; one count a launch."""
    from adapt_image_models_torch.ops import _kernels
    from adapt_image_models_torch.ops._common import temporal_segment_core_plain
    g = torch.Generator().manual_seed(60 + frames)
    qkv = torch.randn(frames * 3, 3 * 128, generator=g).to(cuda, torch.bfloat16)
    before = _kernels.temporal_segment.launches
    got = _kernels.temporal_segment(qkv, 1, frames, 3)
    again = _kernels.temporal_segment(qkv, 1, frames, 3)
    torch.cuda.synchronize()
    assert _kernels.temporal_segment.launches == before + 2
    assert torch.equal(got, again)
    want = temporal_segment_core_plain(qkv, 1, frames, 3, 2)
    _held(f"segment T={frames}", got, want,
          temporal_segment_core_plain(qkv.float(), 1, frames, 3, 2))
    assert (got.float() - want.float()).abs().mean() < MEAN_TOL


@pytest.mark.parametrize("b,heads,n", [(256, 12, 197), (64, 12, 197), (2, 12, 32), (8, 12, 32),
                                       (8, 12, 8), (32, 16, 257), (1, 16, 32), (2, 12, 800),
                                       (1, 2, 801)])
def test_flash_core_branches_match_plain(cuda, b, heads, n):
    """The flash core at every ``tools/kernel_bounds_torch.py``
    ATTENTION_SHAPES entry and one key past the staging bound: against its
    plain version and the unrounded result; strided views and contiguous
    copies bit-equal; two launches bit-equal."""
    q, k, v = _projection_views(cuda, b, heads, n, 70 + n)
    out = ops.flash_attention_core(q, k, v)
    again = ops.flash_attention_core(q, k, v)
    flat = ops.flash_attention_core(*(t.contiguous() for t in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(out, again) and torch.equal(out, flat)
    want = ops.flash_attention_core_plain(q, k, v)
    _held("out", out, want, ops.flash_attention_core_plain(q.float(), k.float(), v.float()))
    assert (out.float() - want.float()).abs().mean() < MEAN_TOL


def test_packed_bf16_products_equal_the_rounded_fp32_product(cuda):
    """``__hmul2`` on packed bf16 pairs, as the segment forward core forms
    its products, bit-equal to ``__floats2bfloat162_rn`` of the fp32
    product on random, tiny (subnormal products), subnormal, huge
    (overflowing), signed-zero, infinite and NaN pairs; NaN to NaN."""
    from adapt_image_models_torch.ops import _kernels
    g = torch.Generator().manual_seed(80)
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"), float("nan"), 1.0, -1.0,
                            1e-39, -1e-39, 9.2e-41, 2.0 ** -126, 2.0 ** -133, 1e-20, 3e38,
                            -3e38])
    a = torch.cat([torch.randn(1 << 16, generator=g), special.repeat_interleave(len(special)),
                   torch.randn(4096, generator=g) * 1e-19])
    b = torch.cat([torch.randn(1 << 16, generator=g), special.repeat(len(special)),
                   torch.randn(4096, generator=g) * 1e-20])
    a, b = (t[:t.numel() // 2 * 2].to(cuda, torch.bfloat16).contiguous() for t in (a, b))
    packed, rounded = _kernels.bf16_products(a, b)
    nan = torch.isnan(packed.float())
    assert torch.equal(nan, torch.isnan(rounded.float())) and nan.any()
    assert torch.equal(packed.view(torch.int16)[~nan], rounded.view(torch.int16)[~nan])
    assert (rounded.float()[~nan] == 0).any()  # products that underflow


# ---------------------------------------------------------------------------
# the spatial backward core (csrc/spatial_bwd.cu: rows and columns kernels,
# ops.spatial_bwd_design)


def _grad_held(name, got, want):
    """PERF.md section 2's bound for backward tensors: elementwise 1e-2
    max|ref| + 1.6e-2 |ref|, and a mean error under 2**-8 of the mean."""
    diff, ref = (got.float() - want.float()).abs(), want.float().abs()
    assert (diff <= 1e-2 * ref.max() + 1.6e-2 * ref).all(), (name, diff.max(), ref.max())
    assert diff.mean() <= 2 ** -8 * ref.mean(), (name, diff.mean(), ref.mean())


@pytest.mark.parametrize("frames,heads,n", [(2, 2, 17), (256, 12, 197), (256, 12, 198),
                                            (128, 16, 257), (4, 2, 289), (2, 2, 768),
                                            (2, 2, 769), (2, 2, 801)])
def test_spatial_backward_core_matches_plain(cuda, frames, heads, n):
    """The spatial backward core at the model paths' shapes, past the former
    288 keys and at its staging bound (768 staged, 769 and 801 streamed):
    dq, dk, dv against ``spatial_core_bwd_plain`` and o against the prenorm
    forward, under PERF.md's backward bound; two launches bit-equal; one
    count a call; the design held to ``ops.spatial_bwd_design``."""
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import spatial_core_bwd_plain, spatial_core_plain
    g = torch.Generator().manual_seed(110 + n)
    d = 64 * heads
    qkv = torch.randn(frames * n, 3 * d, generator=g).to(cuda, torch.bfloat16)
    dout = torch.randn(frames * n, d, generator=g).to(cuda, torch.bfloat16)
    before = K.spatial_attention_bwd.launches
    dqkv = K.spatial_attention_bwd(qkv, dout, frames, n)
    dqkv2, o = K.spatial_attention_bwd(qkv, dout, frames, n, with_out=True)
    again, o2 = K.spatial_attention_bwd(qkv, dout, frames, n, with_out=True)
    torch.cuda.synchronize()
    assert K.spatial_attention_bwd.launches == before + 3
    assert torch.equal(dqkv, dqkv2) and torch.equal(dqkv2, again) and torch.equal(o, o2)
    want = spatial_core_bwd_plain(qkv, dout, frames, n, heads)
    for i, name in enumerate(("dq", "dk", "dv")):
        _grad_held(name, dqkv[:, i * d:(i + 1) * d], want[:, i * d:(i + 1) * d])
    _grad_held("o", o, spatial_core_plain(qkv, frames, n, heads, prenorm=True))
    assert ("aim_spatial_bwd_design", n) in K._designs_held


def test_score_orientations_are_bit_equal(cuda):
    """The columns kernel forms S^T = K Q^T where the rows kernel forms S =
    Q K^T: on the card the two mma orientations give the same fp32 bits, so
    both kernels round P and dS alike."""
    from adapt_image_models_torch.ops import _kernels as K
    g = torch.Generator().manual_seed(120)
    for n in (16, 208, 1024):
        q, k = (torch.randn(n, 64, generator=g).to(cuda, torch.bfloat16) for _ in range(2))
        s, t = K.score_orientations(q, k)
        torch.cuda.synchronize()
        assert torch.equal(s, t), n
        assert (s - q.float() @ k.float().t()).abs().max() < 1e-4


# ---------------------------------------------------------------------------
# the temporal backward cores (csrc/temporal_bwd.cuh, ops.temporal_bwd_design,
# ops.temporal_segment_bwd_design)

# the frames of the checks: the register branch's strips (1, 16, 17, 32, 33,
# 64, 65), whose dP is held whole to 64 frames and formed twice past that,
# its last (144, ViT-B/16 144f) and the staged branch's first (145), and
# each core's first streamed T
TEMPORAL_BWD_FRAMES = (1, 8, 16, 17, 32, 33, 64, 65, 144, 145)
FIRST_STREAMED = {"full": 385, "segment": 257}


@pytest.mark.parametrize("tokens,heads", [(197, 12), (257, 16)])
@pytest.mark.parametrize("frames", TEMPORAL_BWD_FRAMES + ("streamed",))
@pytest.mark.parametrize("core", ["full", "segment"])
def test_temporal_backward_cores_match_plain(cuda, core, frames, tokens, heads):
    """Each temporal backward core on one clip at T frames, ViT-B/16's and
    ViT-L/14's widths: dq, dk, dv and o against its plain version
    (``temporal_core_bwd_plain`` and the prenorm forward, or
    ``temporal_segment_core_bwd_plain``) under PERF.md's backward bound; two
    launches bit-equal; one count a launch; the design held to its twin."""
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import (
        temporal_core_bwd_plain, temporal_core_plain, temporal_segment_core_bwd_plain,
    )
    frames = FIRST_STREAMED[core] if frames == "streamed" else frames
    segment = core == "segment"
    fn, design = ((K.temporal_segment_bwd, "aim_temporal_segment_bwd_design") if segment
                  else (K.temporal_attention_bwd, "aim_temporal_bwd_design"))
    g = torch.Generator().manual_seed(130 + frames)
    d = 64 * heads
    qkv = torch.randn(frames * tokens, 3 * d, generator=g).to(cuda, torch.bfloat16)
    dout = torch.randn(frames * tokens, d, generator=g).to(cuda)
    if not segment:
        dout = dout.to(torch.bfloat16)
    before = fn.launches
    dqkv = fn(qkv, dout, 1, frames, tokens)
    dqkv2, o = fn(qkv, dout, 1, frames, tokens, with_out=True)
    again, o2 = fn(qkv, dout, 1, frames, tokens, with_out=True)
    torch.cuda.synchronize()
    assert fn.launches == before + 3
    assert torch.equal(dqkv, dqkv2) and torch.equal(dqkv2, again) and torch.equal(o, o2)
    if segment:
        want, want_o = temporal_segment_core_bwd_plain(qkv, dout, 1, frames, tokens, heads)
    else:
        want = temporal_core_bwd_plain(qkv, dout, 1, frames, tokens, heads)
        want_o = temporal_core_plain(qkv, 1, frames, tokens, heads, prenorm=True)
    for i, name in enumerate(("dq", "dk", "dv")):
        _grad_held(name, dqkv[:, i * d:(i + 1) * d], want[:, i * d:(i + 1) * d])
    _grad_held("o", o, want_o)
    assert (design, frames) in K._designs_held


# ---------------------------------------------------------------------------
# the full temporal forward core (csrc/attention.cu, ops.temporal_fwd_design)

# two problems to a strip at T = 1 and 8, one strip at 9 and 16, two at 17
# and 32, three at 33, the register branch's last (144) and the staged
# branch's first (145) at both model widths; an odd count of problems (3
# heads), whose last strip holds one; the staged branch's last (800) and the
# streamed branch's first (801) at 17 tokens and 2 heads, where the plain
# version's (T, T) scores stay small
TEMPORAL_FWD_CASES = ([(t, 197, 12) for t in (1, 8, 9, 16, 17, 32, 33, 144, 145)]
                      + [(t, 257, 16) for t in (1, 8, 9, 16, 17, 32, 33, 144, 145)]
                      + [(8, 5, 3), (800, 17, 2), (801, 17, 2)])


@pytest.mark.parametrize("frames,tokens,heads", TEMPORAL_FWD_CASES)
def test_temporal_forward_core_branches_match_plain(cuda, frames, tokens, heads):
    """The full temporal forward core on one clip at each branch point of
    its design: against ``temporal_core_plain`` and the unrounded result;
    two launches bit-equal; one count a launch; the design held to its
    twin."""
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import temporal_core_plain
    g = torch.Generator().manual_seed(170 + frames)
    qkv = torch.randn(frames * tokens, 3 * 64 * heads, generator=g).to(cuda, torch.bfloat16)
    before = K.temporal_attention.launches
    got = K.temporal_attention(qkv, 1, frames, tokens)
    again = K.temporal_attention(qkv, 1, frames, tokens)
    torch.cuda.synchronize()
    assert K.temporal_attention.launches == before + 2
    assert torch.equal(got, again)
    want = temporal_core_plain(qkv, 1, frames, tokens, heads)
    _held(f"temporal forward T={frames}", got, want,
          temporal_core_plain(qkv.float(), 1, frames, tokens, heads))
    assert (got.float() - want.float()).abs().mean() < MEAN_TOL
    assert ("aim_temporal_attention_design", frames) in K._designs_held


# ---------------------------------------------------------------------------
# the GEMM (csrc/gemm.cu: wgmma on TMA-loaded tiles, ops.gemm_design) and the
# spatial forward core (the flash core's launch on the packed QKV)


def _gemm_epilogues(device, m, n, g):
    """Every epilogue option the op chains give ``_kernels.gemm``."""
    from adapt_image_models_torch.ops import _kernels as K

    def r(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=g).to(device, dtype)

    bias, bias2 = r(n, dtype=torch.bfloat16), r(n, dtype=torch.bfloat16)
    res16, res32, aux, gate = r(m, n, dtype=torch.bfloat16), r(m, n), r(m, n), r(-(-m // 5))
    return ({}, dict(bias=bias), dict(bias=bias, out_f32=True),
            dict(bias=bias, act=K.ACT_GELU_TANH), dict(bias=bias, act=K.ACT_QUICK_GELU),
            dict(bias=bias, act=K.ACT_GELU_TANH, out_f32=True, f32_pre_act=True),
            dict(aux=aux, dact=K.ACT_GELU_TANH), dict(aux=aux, dact=K.ACT_QUICK_GELU),
            dict(res_f32=res32, out_f32=True, out_bf16=False),
            dict(bias=bias, res_f32=res32, row_scale=gate, rows_per_scale=5, res_bf16=res16),
            dict(bias=bias, alpha=0.8, row_scale=gate, rows_per_scale=5, res_bf16=res16,
                 bias2=bias2, out_f32=True, out_bf16=False))


@pytest.mark.parametrize("kn", [False, True])
@pytest.mark.parametrize("m,n,k", [(1, 32, 32), (127, 192, 192), (129, 2304, 768),
                                   (1000, 768, 3072), (257, 32, 768), (6000, 768, 192),
                                   (16448, 3072, 1024)])
def test_gemm_matches_plain_under_every_epilogue(cuda, kn, m, n, k):
    """The GEMM in both weight layouts at ragged shapes (M = 1 and not a
    multiple of 128, N and K down to 32, both tile widths of
    ops.gemm_design), under every epilogue option the chains use: each
    output within 1e-2 + 1.6e-2 |ref| of the plain version and a mean
    error under MEAN_TOL; two launches bit-equal; one count a launch."""
    from adapt_image_models_torch.ops import _kernels as K
    g = torch.Generator().manual_seed(90 + m + n + k + kn)
    a = torch.randn(m, k, generator=g).to(cuda, torch.bfloat16)
    w = (0.05 * torch.randn(*((k, n) if kn else (n, k)), generator=g)).to(cuda, torch.bfloat16)
    for kw in _gemm_epilogues(cuda, m, n, g):
        before = K.gemm.launches
        got, again = K.gemm(a, w, kn=kn, **kw), K.gemm(a, w, kn=kn, **kw)
        torch.cuda.synchronize()
        assert K.gemm.launches == before + 2
        want = K.gemm_plain(a, w, kn=kn, **kw)
        for x, y, z in zip(got, again, want):
            assert (x is None) == (z is None), kw
            if x is None:
                continue
            assert torch.equal(x, y), kw
            err = (x.float() - z.float()).abs()
            assert (err <= 1e-2 + 1.6e-2 * z.float().abs()).all(), (sorted(kw), err.max())
            assert err.mean() < MEAN_TOL, (sorted(kw), err.mean())
    assert ("aim_gemm_design", m, n, k, int(kn)) in K._designs_held


def test_gemm_refuses_what_tma_cannot_read(cuda):
    from adapt_image_models_torch.ops import _kernels as K
    a = torch.zeros(64, 96, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):  # N not a multiple of 8
        K.gemm(a, torch.zeros(36, 96, device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):  # an operand off 16-byte alignment
        K.gemm(torch.zeros(64 * 96 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(64, 96),
               torch.zeros(32, 96, device=cuda, dtype=torch.bfloat16))


@pytest.mark.parametrize("frames,heads,n", [(256, 12, 197), (8, 12, 198), (8, 16, 257),
                                            (3, 2, 1), (5, 2, 17), (2, 2, 288)])
def test_spatial_core_matches_plain(cuda, frames, heads, n):
    """The spatial forward core (the flash core on the packed QKV's views)
    against its plain version and the unrounded result, prenorm on and
    off; two launches bit-equal; one count a launch on its own counter,
    none under ``flash_attention_core``; ``spatial_attention_r`` the same
    launch at r = 2, 3 (a short last group)."""
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import spatial_core_plain
    g = torch.Generator().manual_seed(95 + n)
    qkv = torch.randn(frames * n, 3 * 64 * heads, generator=g).to(cuda, torch.bfloat16)
    flash_before = ops.flash_attention_core.launches
    for prenorm in (False, True):
        before = K.spatial_attention.launches
        got = K.spatial_attention(qkv, frames, n, prenorm)
        again = K.spatial_attention(qkv, frames, n, prenorm)
        torch.cuda.synchronize()
        assert K.spatial_attention.launches == before + 2 and torch.equal(got, again)
        want = spatial_core_plain(qkv, frames, n, heads, prenorm)
        _held(f"spatial prenorm={prenorm}", got, want,
              spatial_core_plain(qkv.float(), frames, n, heads, prenorm))
        assert (got.float() - want.float()).abs().mean() < MEAN_TOL
    for r in (2, 3):
        assert torch.equal(K.spatial_attention_r(qkv, frames, n, r),
                           K.spatial_attention(qkv, frames, n))
    assert ops.flash_attention_core.launches == flash_before


# ---------------------------------------------------------------------------
# the LayerNorm row passes (csrc/layernorm.cu, ops.row_pass_design)

# both sides of the designs' branch edge: one chunk a lane (8, 200: lanes
# without a chunk), the models' three and four (768; 1024, the last
# register width), and the streamed branch (1032, 2048, 2056); one row,
# fewer rows than a block's warps, a ragged count, and more rows than the
# persistent grid has warps at 768 and 1024 (the forward's prefetch)
ROW_PASS_ROWS = (1, 7, 33, 4097)
ROW_PASS_WIDTHS = (8, 200, 768, 1024, 1032, 2048, 2056)
# PERF.md §2's forward bound, kernel vs plain version on the card
ROW_ATOL, ROW_RTOL, ROW_MEAN_TOL = 1e-2, 1.6e-2, 1e-4


@pytest.mark.parametrize("d", ROW_PASS_WIDTHS)
@pytest.mark.parametrize("rows", ROW_PASS_ROWS)
def test_row_passes_match_plain(cuda, rows, d):
    """The LayerNorm forward and its backward with and without the
    residual cotangent g against ``layer_norm_fp32`` and
    ``layer_norm_bwd_plain`` (rounded to bf16) under the forward bound; two
    launches bit-equal; one count a launch; both designs held to their
    twin."""
    from adapt_image_models_torch.ops import _kernels as K
    from adapt_image_models_torch.ops._common import layer_norm_bwd_plain, layer_norm_fp32
    g = torch.Generator().manual_seed(1400 + rows + d)

    def r(*shape, s=1.0):
        return (s * torch.randn(*shape, generator=g)).to(cuda)

    x, res = (0.5 + r(rows, d)).to(torch.bfloat16), r(rows, d).to(torch.bfloat16)
    w, b, dy = 1 + r(d, s=0.1), r(d, s=0.1), r(rows, d)
    cases = (("forward", K.layernorm, lambda: K.layernorm(x, w, b),
              lambda: layer_norm_fp32(x, w, b)),
             ("backward with g", K.layernorm_bwd, lambda: K.layernorm_bwd(x, dy, w, res),
              lambda: layer_norm_bwd_plain(x, dy, w, res)),
             ("backward without g", K.layernorm_bwd, lambda: K.layernorm_bwd(x, dy, w),
              lambda: layer_norm_bwd_plain(x, dy, w)))
    for name, fn, kernel, plain in cases:
        before = fn.launches
        got, again = kernel(), kernel()
        torch.cuda.synchronize()
        assert fn.launches == before + 2
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        assert torch.equal(got, again), name
        want = plain().to(torch.bfloat16).float()
        err = (got.float() - want).abs()
        assert (err <= ROW_ATOL + ROW_RTOL * want.abs()).all(), (name, err.max().item())
        assert err.mean() < ROW_MEAN_TOL, (name, err.mean().item())
    assert {("aim_row_pass_design", kind, d) for kind in (0, 1)} <= K._designs_held


# the TPN and audio paths run framework ops only (the JAX package reaches no
# Pallas kernel there): a forward on the card, TF32 off, against the port's
# CPU result of the same weights, with no fused op or core launched
FRAMEWORK_PATHS = {
    "tpn": (dict(type="Recognizer3D",
                 backbone=dict(type="ResNet3dSlowOnly", depth=18, base_channels=16,
                               stage_blocks=(1, 1, 1, 1), out_indices=(2, 3)),
                 neck=dict(type="TPN", in_channels=(64, 128), out_channels=32,
                           downsample_scales=(2, 4), mid_channels=16, fusion_channels=64,
                           aux_head_classes=5),
                 cls_head=dict(type="TPNHead", num_classes=5, in_channels=64)),
            (2, 3, 8, 64, 64)),
    "audio": (dict(type="AudioRecognizer",
                   backbone=dict(type="ResNetAudio", depth=18, base_channels=16),
                   cls_head=dict(type="AudioTSNHead", num_classes=5, in_channels=128)),
              (2, 3, 1, 96, 40)),
}


@pytest.mark.parametrize("name", list(FRAMEWORK_PATHS))
def test_framework_path_matches_cpu(cuda, name, monkeypatch):
    """The eval forward and a train-mode forward (the aux logits and the
    running statistics too) of the toy TPN-SlowOnly and audio recognizer on
    the card against the CPU, TF32 off. The port's float64 evaluation on
    the CPU is the arbiter: the card's fp32 gap to it, over the largest
    magnitude (per tensor sum |diff| / sum |ref| for the statistics), at
    most 2x the CPU's fp32 gap plus 1e-5 (a BatchNorm over few positions
    magnifies rounding in train mode on both devices)."""
    from adapt_image_models_torch.models import build_model
    cfg, shape = FRAMEWORK_PATHS[name]
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    host = build_model(cfg)
    host.init_weights(torch.Generator().manual_seed(0))
    ref = build_model(dict(cfg, backbone=dict(cfg["backbone"], compute_dtype="float64"),
                           **({"neck": dict(cfg["neck"], compute_dtype="float64")}
                              if "neck" in cfg else {})))
    ref.load_state_dict(host.state_dict())
    ref.double()
    card = build_model(cfg, device=cuda)
    card.load_state_dict(host.state_dict())
    x = torch.randn(*shape, generator=torch.Generator().manual_seed(1))
    runs = ((ref, x.double()), (host, x), (card, x.to(cuda)))
    ops.reset_launch_counts()
    for mode in ("eval", "train"):
        outs = []
        for m, inp in runs:
            getattr(m, mode)()
            with torch.no_grad():
                outs.append([m(inp).cpu().double()] + (
                    [m.aux_logits.cpu().double()] if mode == "train" and name == "tpn" else []))
        for want, cpu, got in zip(*outs):
            cpu_gap = ((cpu - want).abs().max() / want.abs().max()).item()
            gap = ((got - want).abs().max() / want.abs().max()).item()
            assert gap <= 2 * cpu_gap + 1e-5, (name, mode, gap, cpu_gap)
    sd = [m.state_dict() for m, _ in runs]
    for k in (k for k in sd[0] if "running" in k):
        want = sd[0][k].double()
        cpu_gap, gap = (((s[k].cpu().double() - want).abs().sum() / want.abs().sum()).item()
                        for s in sd[1:])
        assert gap <= 2 * cpu_gap + 1e-5, (k, gap, cpu_gap)
    assert not any(ops.launch_counts().values())


# ---------------------------------------------------------------------------
# the eval step ops' gradient and the registered ops (aim_port::*)


@pytest.mark.parametrize("op", ["spatial", "temporal", "joint"])
def test_eval_step_gradient_on_the_card(cuda, op):
    """Where autograd records an eval step op on the card, its forward is
    the kernel chain (one launch) and its backward the vector-Jacobian
    product of the JAX package's XLA reference recomputed: bit for bit that
    reference's own gradient, and close to the gradient through the plain
    route (the TPU casts), for x and the adapter weights."""
    from adapt_image_models_torch.ops.fused_joint_mlp import joint_xla
    n, heads, t = 197, 12, 8
    x, ln_w, ln_b, ws = _args(cuda, 2 * t, n, 64 * heads, 16 * heads, 70,
                              joint=op == "joint")
    fns = {"spatial": (fused_spatial_step, fused_spatial_step_plain, tfqa.spatial_step_xla,
                       (heads, True)),
           "temporal": (fused_temporal_step, fused_temporal_step_plain, tfta.temporal_step_xla,
                        (t, heads, False)),
           "joint": (fused_joint, fused_joint_plain, joint_xla, (0.5,))}
    kernel, plain, ref, rest = fns[op]
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(71)).to(x)
    grads = []
    for fn in (kernel, ref, plain):
        leaves = [x.clone().requires_grad_(), *(w.clone().requires_grad_() for w in ws[4:])]
        before = kernel.launches
        out = fn(leaves[0], ln_w, ln_b, *ws[:4], *leaves[1:], *rest)
        if fn is kernel:
            assert type(out.grad_fn).__name__ == "RecomputedVjpBackward"
            assert kernel.launches == before + 1
        grads.append(torch.autograd.grad(out, leaves, g))
    for got, want, through_plain in zip(*grads):
        assert torch.equal(got, want)
        assert got.float().abs().sum() > 0
        diff = (got.float() - through_plain.float()).abs().mean()
        assert diff <= 0.05 * through_plain.float().abs().mean() + 1e-4, (op, diff)
    with torch.no_grad():
        assert kernel(x, ln_w, ln_b, *ws, *rest).grad_fn is None


def test_registered_ops_refuse_misaligned_tensors(cuda):
    """An ``aim_port`` op given a CUDA tensor its kernel does not take
    raises, as the launcher does, rather than running the plain version."""
    from adapt_image_models_torch.ops import _kernels
    rows, d = 4, 64
    shifted = torch.empty(rows * d + 8, dtype=torch.bfloat16, device=cuda)[4:4 + rows * d].view(rows, d)
    w = torch.ones(d, device=cuda)
    b = torch.zeros(d, device=cuda)
    weight = torch.ones(32, d, dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError):
        torch.ops.aim_port.layernorm(shifted, w, b, 1e-5)
    with pytest.raises(ValueError):
        torch.ops.aim_port.gemm(shifted, weight, False, None, 0, None, 0, 1.0, None, None, 1,
                                None, None, False, True, False)
    with pytest.raises(ValueError):
        _kernels.gemm(shifted, weight)
    aligned = torch.randn(rows, d, device=cuda).to(torch.bfloat16)
    got = torch.ops.aim_port.layernorm(aligned, w, b, 1e-5)
    assert torch.equal(got, _kernels.layernorm(aligned, w, b))


def test_exported_eval_matches_the_plain_route(cuda, tmp_path, monkeypatch):
    """A batch-2 artifact of a fused bf16 AIM (head dim 64, seeded
    adapters, one class led in the head's bias) exported on the card holds
    the kernels as ``aim_port`` ops: ``run_exported_evaluation`` over 3
    synthetic videos of 3 views (each video's last chunk padded) launches
    them, and its scores hold the flagship's 1e-3 and top-1 against
    ``run_evaluation`` of the same model on the plain route."""
    from adapt_image_models_torch.apis import run_evaluation, run_exported_evaluation
    from adapt_image_models_torch.models import build_model, layers
    from adapt_image_models_torch.models.backbones import aim
    layers_n, classes = 2, 10
    ann = tmp_path / "ann.txt"
    ann.write_text("\n".join(f"synthetic://{i} {i}" for i in range(3)))
    pipe = [dict(type="SampleFrames", clip_len=8, frame_interval=2, num_clips=3, test_mode=True),
            dict(type="Resize", scale=(-1, 64)), dict(type="CenterCrop", crop_size=64),
            dict(type="Normalize"), dict(type="FormatShape", input_format="NCTHW")]
    model_cfg = dict(type="Recognizer3D",
                     backbone=dict(type="AIM", input_resolution=64, patch_size=16, width=128,
                                   layers=layers_n, heads=2, num_frames=8,
                                   compute_dtype="bfloat16", attention_core="fused"),
                     cls_head=dict(type="I3DHead", num_classes=classes, in_channels=128))
    cfg = dict(model=dict(model_cfg, test_cfg=dict(average_clips="prob")),
               data=dict(test=dict(type="VideoDataset", ann_file=str(ann), pipeline=pipe)))
    model = build_model(model_cfg, test_cfg=dict(average_clips="prob"), device=cuda)
    g = torch.Generator().manual_seed(80)
    model.init_weights(g)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if ".D_fc2." in name or name.endswith("temporal_embedding"):
                p.copy_(0.02 * torch.randn(p.shape, generator=g))
        model.cls_head.fc_cls.bias[3] += 2.0
    model.eval()
    path = str(tmp_path / "aim.pt2")
    with torch.no_grad():
        torch.export.save(torch.export.export(model, (torch.zeros(2, 3, 8, 64, 64, device=cuda),)),
                          path)
    ops.reset_launch_counts()
    _, got, _ = run_exported_evaluation(cfg, path, return_scores=True, num_workers=1)
    calls = 3 * 2  # a video's 3 views in two calls of 2, the last padded
    cores = ops.core_launch_counts()
    assert cores["spatial_attention"] == cores["temporal_attention"] == calls * layers_n
    assert cores["gemm"] == 12 * calls * layers_n
    assert not any(ops.launch_counts().values())
    for mod, name in ((layers, "fused_spatial_step"), (layers, "fused_temporal_step"),
                      (aim, "fused_joint")):
        monkeypatch.setattr(mod, name, getattr(ops, name + "_plain"))
    _, want, _ = run_evaluation(cfg, model=model, return_scores=True, num_workers=1)
    assert got.shape == (3, classes) and np.isfinite(got).all()
    assert np.abs(got - want).max() < 1e-3
    assert (got.argmax(1) == want.argmax(1)).all()
