"""The GEMM's design (``csrc/gemm.cu``: wgmma on TMA-loaded tiles) and the
spatial forward core's route through the flash core
(``csrc/flash_attention.cu``), on the CPU.

The GEMM picks its tile width by size, a plain function in the port's
Python (``ops.gemm_design``) that the wrapper holds the kernel's C twin
to. Here:

* the design takes every (M, N, K, layout) that the op chains make at
  ViT-B/16, ViT-L/14 and the checks' width 128 (adapter products with K or
  N = 32), M = 1 and ragged M, within one block's 232,448 bytes of shared
  memory, and refuses K or N that TMA's 16-byte rows cannot read (not a
  multiple of 8), as the wrapper does before it touches the library;
* its branch points, and the wrapper's hold of the C twin (a fake library);
* the GEMM's plain version (``_kernels.gemm_plain``, which the card holds
  the kernel to) against the same epilogue in float64 on the same bf16
  operands, under each option the chains use, in both weight layouts: it
  sums bf16 products in fp32, so its fp32 result is within 1e-5 of the
  float64 one and its bf16 result within one bf16 ulp;
* the spatial forward core: ``_kernels.spatial_attention`` hands the flash
  core the q, k, v views of the packed (frames*L, 3D) QKV, strides (L*3D,
  64, 3D), and writes o into the (frames*L, D) rows; on those views the
  flash core's plain version, ``prenorm`` too, equals the spatial core's
  plain version bit for bit at L = 1, 2, 197, 198, 257 and 288, and the
  routed wrappers (``spatial_attention`` and ``spatial_attention_r`` at
  every r) give that result through a stand-in for the kernel's launch.

The card tests of both kernels are in ``tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import (
    gelu_tanh_grad, quick_gelu_grad, spatial_core_plain,
)

SMEM_MAX = 232448
# (width, rows) of the chains: ViT-B/16 at 32 clips x 8 frames and at one
# clip's 3 views, ViT-L/14 at 4 clips x 32 frames, the checks' width 128
# at toy rows, and M = 1 and ragged M
CHAIN_GEOMETRIES = ((768, 50432), (768, 4728), (1024, 32896), (1024, 257), (128, 37 * 4),
                    (768, 1), (128, 1), (768, 127), (768, 129))


def chain_products(d):
    """(n, k, kn) of every product the op chains make at width d: the
    forward projections (QKV, out, adapter down and up, MLP fc and proj)
    on the (N, K) weight, and their backward twins on the (K, N) weight."""
    dh, dm = d // 4, 4 * d
    forward = ((3 * d, d), (d, d), (dh, d), (d, dh), (dm, d), (d, dm))
    return [(n, k, False) for n, k in forward] + [(k, n, True) for n, k in forward]


@pytest.mark.parametrize("d,m", CHAIN_GEOMETRIES)
def test_gemm_design_takes_every_chain_product(d, m):
    for n, k, kn in chain_products(d):
        branch, smem = ops.gemm_design(m, n, k, kn)
        assert branch in ("bn128", "bn256"), (m, n, k, kn, branch)
        bn = int(branch[2:])
        stages = _kernels.GEMM_STAGES[bn]
        assert stages >= 3 and smem <= SMEM_MAX, (m, n, k, smem)
        # the ring, its 1024-byte alignment slack and the mbarriers
        assert smem >= stages * 2 * 64 * (128 + bn) + 1024 + 16 * stages
        assert ops.gemm_design(m, n, k, not kn) == (branch, smem)  # the layout takes no part


@pytest.mark.parametrize("m,n,branch", [
    (50432, 2304, "bn256"), (50432, 768, "bn256"), (50432, 504, "bn128"),
    (50432, 192, "bn128"), (44 * 128, 768, "bn256"), (44 * 128 - 128, 768, "bn128"),
    (33 * 128, 1024, "bn256"), (1, 3072, "bn128"), (0, 768, "bn128")])
def test_gemm_design_branch_points(m, n, branch):
    """256-wide tiles where N holds two of them and the tiles make a full
    wave on 132 SMs (44 row tiles x 3 = 132 at N = 768)."""
    assert ops.gemm_design(m, n, 768)[0] == branch


@pytest.mark.parametrize("n,k", [(36, 768), (768, 12), (0, 768), (768, 0), (770, 768)])
def test_gemm_refuses_rows_tma_cannot_read(n, k):
    with pytest.raises(ValueError):
        ops.gemm_design(128, n, k)
    # the wrapper refuses before it builds or loads the library
    a = torch.zeros(4, max(k, 1), dtype=torch.bfloat16)
    w = torch.zeros(max(n, 1), max(k, 1), dtype=torch.bfloat16)
    if n and k:
        with pytest.raises(ValueError):
            _kernels.gemm(a, w)


def test_gemm_refuses_mismatched_or_strided_operands():
    a = torch.zeros(4, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        _kernels.gemm(a, torch.zeros(32, 48, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        _kernels.gemm(torch.zeros(4, 128, dtype=torch.bfloat16)[:, :64],
                      torch.zeros(32, 64, dtype=torch.bfloat16))


class _FakeLibrary:
    """The GEMM's design entry of the kernel library, answering (code, smem)."""

    def __init__(self, code, smem):
        self.code, self.smem = code, smem

    def aim_gemm_design(self, m, n, k, kn, smem_ref):
        smem_ref._obj.value = self.smem
        return self.code


def test_wrapper_holds_the_c_gemm_design_to_its_twin(monkeypatch):
    plain, branches = _kernels._DESIGNS["aim_gemm_design"]
    size = (50432, 2304, 768, 1)
    branch, smem = plain(*size)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary(branches.index(branch), smem))
    _kernels._hold_design("aim_gemm_design", *size)
    assert ("aim_gemm_design", *size) in _kernels._designs_held
    for code, bytes_ in ((branches.index(branch), smem + 16), (1 - branches.index(branch), smem),
                         (-1, smem)):
        monkeypatch.setattr(_kernels, "_designs_held", set())
        monkeypatch.setattr(_kernels, "library", lambda c=code, b=bytes_: _FakeLibrary(c, b))
        with pytest.raises(RuntimeError):
            _kernels._hold_design("aim_gemm_design", *size)


def _epilogue64(a, w, kn, bias=None, act=0, aux=None, dact=0, alpha=1.0, res_f32=None,
                row_scale=None, rows_per_scale=1, res_bf16=None, bias2=None, f32_pre_act=False,
                **_):
    """csrc/gemm.cu's epilogue in float64: (the fp32 output's value, the
    final value)."""
    def gelu_tanh64(x):
        return 0.5 * x * (1 + torch.tanh(0.7978845608028654 * (x + 0.044715 * x ** 3)))

    acts = {0: lambda x: x, 1: lambda x: x * torch.sigmoid(1.702 * x), 2: gelu_tanh64}
    grads = {0: torch.ones_like, 1: quick_gelu_grad, 2: gelu_tanh_grad}
    v = a.double() @ (w.double() if kn else w.double().t())
    if bias is not None:
        v = v + bias.double()
    pre = v
    v = acts[act](v)
    if aux is not None:
        v = v * grads[dact](aux.double())
    v = v * alpha
    if res_f32 is not None:
        v = res_f32.double() + v
    if row_scale is not None:
        v = v * row_scale.double()[torch.arange(v.shape[0]) // rows_per_scale][:, None]
    if res_bf16 is not None:
        v = res_bf16.double() + v
    if bias2 is not None:
        v = v + bias2.double()
    return (pre if f32_pre_act else v), v


@pytest.mark.parametrize("kn", [False, True])
def test_gemm_plain_matches_its_epilogue_in_float64(kn):
    rng = np.random.default_rng(1100 + kn)
    m, k, n = 37, 64, 48

    def t(*shape, scale=1.0, dtype=torch.bfloat16):
        return torch.from_numpy(scale * rng.standard_normal(shape)).to(dtype)

    a = t(m, k)
    w = t(k, n, scale=0.1) if kn else t(n, k, scale=0.1)
    bias, bias2, res16 = t(n), t(n), t(m, n)
    res32, aux = t(m, n, dtype=torch.float32), t(m, n, dtype=torch.float32)
    gate = t(m // 5 + 1, dtype=torch.float32)
    A = _kernels
    cases = (dict(bias=bias), dict(bias=bias, act=A.ACT_GELU_TANH, out_f32=True, f32_pre_act=True),
             dict(bias=bias, act=A.ACT_QUICK_GELU), dict(aux=aux, dact=A.ACT_GELU_TANH),
             dict(aux=aux, dact=A.ACT_QUICK_GELU), dict(res_f32=res32, out_f32=True),
             dict(bias=bias, alpha=0.5, row_scale=gate, rows_per_scale=5, res_bf16=res16,
                  bias2=bias2, out_f32=True, out_bf16=False),
             dict(res_f32=res32, row_scale=gate, rows_per_scale=5, res_bf16=res16))
    for kw in cases:
        o32, o16 = A.gemm_plain(a, w, kn=kn, **kw)
        want32, want = _epilogue64(a, w, kn, **kw)
        if kw.get("out_f32"):
            assert (o32.double() - want32).abs().max() < 1e-5 * (1 + want32.abs().max()), kw
        else:
            assert o32 is None
        if kw.get("out_bf16", True):
            ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(1e-3))) - 7)
            assert ((o16.double() - want).abs() <= ulp).all(), kw
        else:
            assert o16 is None


SPATIAL_LENGTHS = (1, 2, 197, 198, 257, 288)


def _packed_qkv(frames, length, heads, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal((frames * length, 3 * 64 * heads))).to(
        torch.bfloat16)


@pytest.mark.parametrize("length", SPATIAL_LENGTHS)
def test_flash_plain_on_packed_views_equals_spatial_plain(length):
    frames, heads = 2, 2
    qkv = _packed_qkv(frames, length, heads, 1200 + length)
    out = torch.empty(frames * length, 64 * heads, dtype=torch.bfloat16)
    q, k, v, o = _kernels.spatial_views(qkv, out, frames, length)
    d = 64 * heads
    def strides(t):  # a dimension of size 1 has no stride that matters
        return tuple(s if n > 1 else None for s, n in zip(t.stride(), t.shape))

    for t in (q, k, v):
        assert t.shape == (frames, heads, length, 64)
        assert strides(t) == strides(torch.empty_strided(t.shape, (length * 3 * d, 64, 3 * d, 1)))
    assert (q.data_ptr(), k.data_ptr(), v.data_ptr()) == (
        qkv.data_ptr(), qkv.data_ptr() + 2 * d, qkv.data_ptr() + 4 * d)
    assert strides(o) == strides(torch.empty_strided(o.shape, (length * d, 64, d, 1)))
    assert o.data_ptr() == out.data_ptr()
    for prenorm in (False, True):
        o.copy_(ops.flash_attention_core_plain(q, k, v, prenorm=prenorm))
        want = spatial_core_plain(qkv, frames, length, heads, prenorm=prenorm)
        assert torch.equal(out, want), (length, prenorm)


def test_spatial_wrappers_route_to_the_flash_launch(monkeypatch):
    """``spatial_attention`` and ``spatial_attention_r`` launch the flash
    core once on the views above, with ``prenorm`` as asked, and return
    its rows: a stand-in for the launch writes the plain flash core into
    the o it is given. Each call counts one launch on the spatial core's
    own counter and none under an op (``flash_attention_core`` included)."""
    calls = []

    def fake_launch(q, k, v, o=None, prenorm=False):
        calls.append(prenorm)
        o.copy_(ops.flash_attention_core_plain(q, k, v, prenorm=prenorm))
        return o

    monkeypatch.setattr(_kernels, "flash_attention", fake_launch)
    ops.reset_launch_counts()
    frames, length, heads = 5, 198, 2
    qkv = _packed_qkv(frames, length, heads, 1250)
    for prenorm in (False, True):
        got = _kernels.spatial_attention(qkv, frames, length, prenorm=prenorm)
        assert torch.equal(got, spatial_core_plain(qkv, frames, length, heads, prenorm=prenorm))
    want = spatial_core_plain(qkv, frames, length, heads)
    for r in (1, 2, 3, 5, 7):  # a short last group at r = 2, 3
        assert torch.equal(_kernels.spatial_attention_r(qkv, frames, length, r), want)
    assert calls == [False, True] + [False] * 5
    assert _kernels.spatial_attention.launches == 7
    assert not any(ops.launch_counts().values())
    ops.reset_launch_counts()
    assert _kernels.spatial_attention.launches == 0
    with pytest.raises(ValueError):
        _kernels.spatial_attention_r(qkv, frames, length, 0)
