"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: without an NVIDIA GPU every test here skips. This file
imports no JAX, so it also runs on a GPU host without it:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(``--noconftest`` skips ``tests/conftest.py``, which imports JAX.)

Shapes are small but cover what the kernels must mask: a token count that
is not a multiple of 16 or 64, a row count that is not a multiple of 128,
adapter widths that are not a multiple of the 128-wide GEMM tile, and the
ViT-L geometry (257 tokens, 16 heads, T=32).

The train ops are checked forward and backward (output, dx and the
adapter cotangents), with drop-path gates that hold zeros and 1/keep; the
plain temporal and spatial attention blocks forward and backward (output,
dx, dqkv, o, and through their autograd ops every weight cotangent), the
spatial one at the prompt token's odd length 198 and the temporal one at
the flash variants' single class token per frame.

Tolerance. Kernel and plain version round the same intermediates to bf16
but sum fp32 products in different orders, so single values can land a few
bf16 ulps apart where a rounding flip is amplified. Each is therefore held
against the unrounded result (the plain version run in fp32 throughout):
the kernel's max error may be at most 2x the plain version's plus 1e-2,
and its mean error at most 1.25x plus 1e-5. Kernel and plain version must
also agree to 2e-3 in mean absolute difference.
"""

import pytest
import torch

from adapt_image_models_torch.ops import (
    fused_attention_block, fused_attention_block_plain, fused_joint,
    fused_joint_mlp_rows_bwd, fused_joint_plain, fused_qkv_attention,
    fused_qkv_attention_bwd, fused_qkv_attention_bwd_plain, fused_qkv_attention_plain,
    fused_joint_train_block, fused_joint_train_block_plain, fused_spatial_step,
    fused_spatial_step_plain, fused_spatial_train_step,
    fused_spatial_train_step_plain, fused_step_bwd_dx, fused_temporal_attention,
    fused_temporal_attention_bwd, fused_temporal_attention_bwd_plain,
    fused_temporal_attention_plain, fused_temporal_block, fused_temporal_block_plain,
    fused_temporal_step, fused_temporal_step_bwd_dx, fused_temporal_step_plain,
    fused_temporal_train_step, fused_temporal_train_step_plain,
)

pytestmark = pytest.mark.cuda

MEAN_TOL = 2e-3


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
    with pytest.raises(NotImplementedError):  # T > 32
        fused_temporal_step(x.repeat(16, 1, 1), w, b, *ws, 64, 2, False)


def _train_check(op, plain, bwd_op, x, ln_w, ln_b, weights, gate, *rest):
    """Run the train op forward and backward once on the card and hold its
    output, dx and adapter cotangents against the plain version's."""
    g = torch.Generator().manual_seed(7)
    cot = torch.randn(x.shape, generator=g).to(x.device)

    def run(fn, dtype):
        xx = x.detach().to(dtype).clone().requires_grad_()
        frozen = [w.to(dtype) for w in weights[:4]]
        ad = [w.detach().to(dtype).clone().requires_grad_() for w in weights[4:]]
        out = fn(xx, ln_w, ln_b, *frozen, *ad, gate, *rest)
        out.backward(cot.to(dtype))
        return [t.float() for t in (out.detach(), xx.grad, *(w.grad for w in ad))]

    before = (op.launches, bwd_op.launches)
    got = run(op, torch.bfloat16)
    torch.cuda.synchronize()
    assert (op.launches, bwd_op.launches) == (before[0] + 1, before[1] + 1)
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
def test_spatial_train_kernels_match_plain(cuda, n, heads):
    x, w, b, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 4)
    _train_check(fused_spatial_train_step, fused_spatial_train_step_plain,
                 fused_step_bwd_dx, x, w, b, ws, None, heads, True)


@pytest.mark.parametrize("t,heads", [(4, 2), (8, 12), (32, 2), (32, 16)])
def test_temporal_train_kernels_match_plain(cuda, t, heads):
    x, w, b, ws = _args(cuda, 2 * t, 37, 64 * heads, 16 * heads, 5)
    _train_check(fused_temporal_train_step, fused_temporal_train_step_plain,
                 fused_temporal_step_bwd_dx, x, w, b, ws, _gate(cuda, 2 * t), t,
                 heads, False)


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


@pytest.mark.parametrize("n,heads", [(17, 2), (197, 12), (198, 12), (257, 16)])
def test_spatial_block_kernels_match_plain(cuda, n, heads):
    """The plain spatial attention block; 198 is ViT-B/16's tokens with the
    prompt token."""
    x, _, _, ws = _args(cuda, 6, n, 64 * heads, 16 * heads, 11)
    g = torch.randn(x.shape, generator=torch.Generator().manual_seed(12)).to(x)
    _block_check(fused_qkv_attention, fused_qkv_attention_bwd, fused_qkv_attention_plain,
                 fused_qkv_attention_bwd_plain, fused_attention_block,
                 fused_attention_block_plain, x, ws[:4], g, heads)


def test_spatial_block_refuses_what_it_does_not_take(cuda):
    x, _, _, ws = _args(cuda, 2, 289, 128, 32, 13)
    with pytest.raises(NotImplementedError):  # more keys than the core holds
        fused_qkv_attention(x, *ws[:4], 2)
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
    with pytest.raises(NotImplementedError):  # T > 32
        fused_temporal_attention(x.repeat(16, 1, 1), *ws[:4], 64, 2)
    with pytest.raises(ValueError):  # a cotangent unlike x
        fused_temporal_attention_bwd(x, *ws[:3], x.float(), 2, 2)
