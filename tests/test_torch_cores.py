"""The two attention cores with branch points on the card: the segment-sum
temporal forward core (``csrc/temporal_segment.cu``) and the flash core
(``csrc/flash_attention.cu``).

Each CUDA kernel picks a design by size: the segment core keeps a strip's
scores in registers up to 64 and up to 128 frames, recomputes them in three
passes from K and V staged in shared memory up to 800 frames and streams K
and V through a ring past that; the flash core stages K and V whole up to
800 keys and streams them past that. The choice is a plain function of the
size in the port's Python (``ops.segment_fwd_design``,
``ops.flash_fwd_design``), and the wrappers hold the kernels' C twins to it.
Here, on the CPU:

* the design helpers: their branch points, and shared memory within one
  block's 232,448 bytes on every branch, enough for the rows each stages;
* the wrappers' hold: a C design that disagrees with its twin raises;
* the plain versions, which the kernels are held to on the card, at the
  branch points' sizes against attention in float64 on the same bf16
  inputs: the segment core (1 clip, 2 tokens, 2 heads) rounds each product
  q_d k_d to bf16, which moves a score by about 2**-9 of |q||k|, and
  rounds P and o, so max error 3e-2 and mean error 2e-3 (the bounds of
  ``tests/test_torch_longclip.py`` at T = 48); the flash core (1 batch, 2
  heads) rounds only P and o, so max error 1e-2 and mean error 1e-3;
* the plain flash core against the Pallas kernel (interpret mode) at the
  staging bound and one key past it, within one bf16 ulp, as
  ``tests/test_torch_vitclip.py`` holds it at the ViT lengths;
* the segment core's launch counter: CPU tensors take the plain version
  and launch nothing;
* the core-only bounds of ``tools/kernel_bounds_torch.py`` (the segment
  core alone, the spatial cores alone, the GEMM at its timed shapes).
"""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax.numpy as jnp
from adapt_image_models_tpu.ops import flash_attention as jax_flash
from adapt_image_models_torch import ops
from adapt_image_models_torch.ops import _kernels
from adapt_image_models_torch.ops._common import temporal_segment_core_plain

SMEM_MAX = 232448
ROW_BYTES = 144  # a staged 64-lane bf16 row with its 8 lanes of padding

SEGMENT_FRAMES = (33, 64, 65, 128, 129, 300, 801)
FLASH_LENGTHS = (8, 32, 197, 257, 800, 801)


@pytest.mark.parametrize("frames,branch", [
    (1, "registers64"), (33, "registers64"), (64, "registers64"), (65, "registers128"),
    (128, "registers128"), (129, "staged"), (300, "staged"), (800, "staged"),
    (801, "streamed"), (5000, "streamed")])
def test_segment_design_branch_points(frames, branch):
    got, smem = ops.segment_fwd_design(frames)
    assert got == branch
    if branch == "streamed":
        assert smem == 2 * 2 * 64 * ROW_BYTES  # two ring slots of 64 frames of K and V
    else:
        pad = 16 if branch.startswith("registers") else 32
        assert smem == 2 * (-(-frames // pad) * pad) * ROW_BYTES


@pytest.mark.parametrize("length,branch", [
    (1, "staged"), (197, "staged"), (257, "staged"), (800, "staged"), (801, "streamed"),
    (4096, "streamed")])
def test_flash_design_branch_points(length, branch):
    got, smem = ops.flash_fwd_design(length)
    assert got == branch
    assert smem == (2 * (-(-length // 16) * 16) * ROW_BYTES if branch == "staged"
                    else 2 * 2 * 64 * ROW_BYTES)


def test_designs_fit_one_block_and_hold_their_rows():
    """At every size up to 1000: shared memory within one block's, and a
    staged design holds all of K and V."""
    for size in range(1, 1001):
        for design, staged in ((ops.segment_fwd_design, ("registers64", "registers128", "staged")),
                               (ops.flash_fwd_design, ("staged",))):
            branch, smem = design(size)
            assert 0 < smem <= SMEM_MAX, (design.__name__, size, smem)
            if branch in staged:
                assert smem >= 2 * size * ROW_BYTES, (design.__name__, size, smem)
    with pytest.raises(ValueError):
        ops.segment_fwd_design(0)
    with pytest.raises(ValueError):
        ops.flash_fwd_design(0)


class _FakeLibrary:
    """Design entries of the kernel library that answer (code, smem)."""

    def __init__(self, code, smem):
        self.code, self.smem = code, smem

    def _design(self, size, smem_ref):
        smem_ref[0] = self.smem
        return self.code

    aim_temporal_segment_design = aim_flash_attention_design = _design


@pytest.mark.parametrize("c_name,size", [("aim_temporal_segment_design", 65),
                                         ("aim_flash_attention_design", 801)])
def test_wrapper_holds_the_c_design_to_its_twin(monkeypatch, c_name, size):
    plain, branches = _kernels._DESIGNS[c_name]
    branch, smem = plain(size)
    monkeypatch.setattr(_kernels, "_designs_held", set())
    monkeypatch.setattr(_kernels, "library", lambda: _FakeLibrary(branches.index(branch), smem))
    _kernels._hold_design(c_name, size)  # agrees
    assert (c_name, size) in _kernels._designs_held
    for code, bytes_ in ((branches.index(branch), smem + 16), ((branches.index(branch) + 1)
                                                                % len(branches), smem)):
        monkeypatch.setattr(_kernels, "_designs_held", set())
        monkeypatch.setattr(_kernels, "library", lambda c=code, b=bytes_: _FakeLibrary(c, b))
        with pytest.raises(RuntimeError):
            _kernels._hold_design(c_name, size)


@pytest.mark.parametrize("frames", SEGMENT_FRAMES)
def test_plain_segment_core_against_float64(frames):
    """``temporal_segment_core_plain`` (1 clip, 2 tokens, 2 heads, bf16)
    against softmax attention over the frames in float64 on the same q, k
    and v, at each branch point of the kernel."""
    length, heads = 2, 2
    d = 64 * heads
    rng = np.random.default_rng(900 + frames)
    qkv = torch.from_numpy(rng.standard_normal((frames * length, 3 * d))).to(torch.bfloat16)
    got = temporal_segment_core_plain(qkv, 1, frames, length, heads).double()
    q, k, v = (t.double().view(1, frames, length, heads, 64).permute(0, 2, 3, 1, 4)
               for t in qkv.split(d, -1))
    want = (torch.softmax(q @ k.transpose(-1, -2) / 8.0, -1) @ v)
    want = want.permute(0, 3, 1, 2, 4).reshape(-1, d)
    err = (got - want).abs()
    assert err.max() < 3e-2 and err.mean() < 2e-3, (err.max(), err.mean())


@pytest.mark.parametrize("length", FLASH_LENGTHS)
def test_plain_flash_core_against_float64(length):
    """``flash_attention_core_plain`` (1 batch, 2 heads, bf16) against
    softmax attention in float64 on the same q, k and v, at the ViT_CLIP
    paths' lengths (``tools/kernel_bounds_torch.py`` ATTENTION_SHAPES), the
    staging bound and one key past it."""
    rng = np.random.default_rng(950 + length)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 2, length, 64))).to(torch.bfloat16)
               for _ in range(3))
    got = ops.flash_attention_core_plain(q, k, v).double()
    want = torch.softmax(q.double() @ k.double().transpose(-1, -2) / 8.0, -1) @ v.double()
    err = (got - want).abs()
    assert err.max() < 1e-2 and err.mean() < 1e-3, (err.max(), err.mean())


@pytest.mark.parametrize("length", [800, 801])
def test_plain_flash_core_matches_pallas_past_the_staging_bound(length):
    """The plain flash core against the Pallas kernel in interpret mode on
    the same bf16 q, k, v (1 batch, 2 heads): within one bf16 ulp of
    max(|o|, 0.5), and at most 2e-3 of the values apart."""
    rng = np.random.default_rng(970 + length)
    arrs = [rng.standard_normal((1, 2, length, 64)).astype(np.float32) for _ in range(3)]
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in arrs)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_flash.flash_attention_core(jq, jk, jv).astype(jnp.float32))
    got = ops.flash_attention_core(tq, tk, tv).float().numpy()
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 0.5))) - 7)
    assert (np.abs(got - want) / ulp).max() <= 1.0
    assert np.mean(got != want) <= 2e-3


def test_segment_core_counter_moves_only_on_a_launch():
    """A temporal op past LONG_CLIP_T on CPU tensors takes the plain segment
    core: the core's counter stays 0, and reset_launch_counts zeroes it."""
    _kernels.temporal_segment.launches = 3
    ops.reset_launch_counts()
    assert _kernels.temporal_segment.launches == 0
    g = torch.Generator().manual_seed(990)
    d, frames = 128, 33
    x = torch.randn(frames, 3, d, generator=g)
    w = [0.05 * torch.randn(*s, generator=g) for s in ((3 * d, d), (3 * d,), (d, d), (d,))]
    out = ops.fused_temporal_attention(x, *w, frames, 2)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert _kernels.temporal_segment.launches == 0
    assert ops.launch_counts()["fused_temporal_attention"] == 0


def _kernel_bounds():
    import importlib.util
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "kernel_bounds_torch.py")
    spec = importlib.util.spec_from_file_location("kernel_bounds_torch", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_core_bounds(capsys):
    """``tools/kernel_bounds_torch.py``'s core-only bounds: the segment
    forward core moves q, k, v and o once (4 x 2 B x 64 a row and head)
    and does row 13's core FLOPs over the frames; the GEMM moves its two
    operands and its result once and does 2mkn FLOPs; ``--cores`` prints
    the segment core at the shape and every GEMM of GEMM_SHAPES."""
    kb = _kernel_bounds()
    flops, nbytes = kb.segment_core_work(4, 64, 197, 768)
    rows = 4 * 64 * 197
    assert nbytes == 4 * 2 * rows * 768 and flops == 4 * rows * 64 * 768
    ms, by = kb.bound_of(flops, nbytes)
    assert by == "bytes" and abs(ms - nbytes / 3.35e12 * 1e3) < 1e-12
    # the same count as row 13's core over (B, H, L, 64) = (clips*L, H, T, 64)
    assert (flops, nbytes) == kb.work(13, clips=4 * 197, frames=1, tokens=64, width=768)
    assert kb.gemm_work(50432, 768, 2304) == (2 * 50432 * 768 * 2304,
                                              2 * (50432 * 768 + 2304 * 768 + 50432 * 2304))
    assert kb.bound_of(*kb.gemm_work(50432, 768, 2304))[1] == "operations"
    kb.main(["--cores", "--clips", "4", "--frames", "64"])
    out = capsys.readouterr().out
    assert "segment forward core" in out and out.count("wgmma GEMM") == len(kb.GEMM_SHAPES)
