"""Each fused op of the PyTorch port against its JAX Pallas kernel.

The same seeded numpy inputs go through the JAX kernel (Mosaic interpret
mode, as ``tests/test_ops/test_fused_kernels.py`` runs it on the CPU) and
through the port's wrapper, which on CPU tensors takes its plain PyTorch
version. Weights are handed over in each package's layout: (in, out) for
JAX, (out, in) for the port.

Tolerances (measured on a CPU: bit-equal at bf16, 2.4e-7 at fp32):
* fp32: the two sides sum the same fp32 products in different orders;
  with K <= 512 terms and outputs below ~5 that moves a result by a few
  1e-6, so the bound is 2e-5. That is tighter than the JAX suite's bounds
  for these kernels (5e-4, 2e-3: test_fused_kernels.py:180,244,251) so
  that swapping the adapters' tanh GELU for the erf form (a ~1e-4 change
  here) fails.
* bf16: both sides round the same intermediates to bf16 (LN output, QKV,
  probabilities, attention output, fp32 y kept unrounded, adapter hidden,
  result), so only a different fp32 summation order can move a value across
  a bf16 rounding boundary, by one ulp (2**-8 to 2**-7 of the value), in a
  few elements. The bound is 2**-7 * |ref| + 1e-3 elementwise and 1e-4 on
  the mean absolute error, which a cast left out or added fails.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.ops.fused_joint_mlp import (
    fused_joint_mlp_adapter, fused_joint_mlp_rows,
)
from adapt_image_models_tpu.ops.fused_qkv_attention import (
    fused_ln_attn_adapter_residual,
)
from adapt_image_models_tpu.ops.fused_temporal_attention import (
    fused_ln_temporal_adapter_residual,
)
from adapt_image_models_torch.ops import (
    fused_joint, fused_joint_plain, fused_spatial_step,
    fused_spatial_step_plain,
    fused_temporal_step, fused_temporal_step_plain, launch_counts,
    reset_launch_counts,
)

B, T, N, D, HEADS = 2, 4, 5, 128, 2  # res 32 / patch 16 -> 5 tokens, hd 64
DH = D // 4

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_TOL = 2 ** -7, 1e-3, 1e-4


def _weights(seed, shapes):
    rng = np.random.default_rng(seed)
    return [(0.05 * rng.standard_normal(s)).astype(np.float32) for s in shapes]


def _ln(seed):
    rng = np.random.default_rng(seed)
    return ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
            (0.1 * rng.standard_normal(D)).astype(np.float32))


def _to_jax(a, dtype):
    return jnp.asarray(a).astype(dtype)


def _to_torch(a, dtype):
    return torch.from_numpy(np.ascontiguousarray(a)).to(dtype)


def _compare(out_torch, out_jax, dtype):
    got = out_torch.float().numpy()
    want = np.asarray(jnp.asarray(out_jax, jnp.float32))
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)
    else:
        np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_ATOL)
        assert np.abs(got - want).mean() < BF16_MEAN_TOL


def _attention_case(seed, dtype, rows):
    x = np.random.default_rng(seed).standard_normal((rows, N, D)).astype(np.float32)
    lns, lnb = _ln(seed + 1)
    wqkv, bqkv, wout, bout, w1, b1, w2, b2 = _weights(
        seed + 2, [(D, 3 * D), (3 * D,), (D, D), (D,), (D, DH), (DH,), (DH, D), (D,)])
    # adapter pre-activations of O(1), where the tanh and erf GELUs differ
    w1, w2 = 6 * w1, 2 * w2
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jargs = (_to_jax(x, jdt), jnp.asarray(lns), jnp.asarray(lnb),
             *(_to_jax(w, jdt) for w in (wqkv, bqkv, wout, bout, w1, b1, w2, b2)))
    targs = (_to_torch(x, tdt), _to_torch(lns, torch.float32),
             _to_torch(lnb, torch.float32),
             *(_to_torch(w, tdt) for w in (wqkv.T, bqkv, wout.T, bout, w1.T, b1,
                                          w2.T, b2)))
    return jargs, targs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
def test_spatial_step_matches_pallas(dtype, skip):
    jargs, targs = _attention_case(0, dtype, B * T)
    with pltpu.force_tpu_interpret_mode():
        want = fused_ln_attn_adapter_residual(*jargs, HEADS, skip)
    got = fused_spatial_step(*targs, HEADS, skip)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("skip", [True, False])
def test_temporal_step_matches_pallas(dtype, skip):
    jargs, targs = _attention_case(10, dtype, B * T)
    with pltpu.force_tpu_interpret_mode():
        want = fused_ln_temporal_adapter_residual(*jargs, T, HEADS, skip)
    got = fused_temporal_step(*targs, T, HEADS, skip)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_joint_step_matches_pallas(dtype):
    rng = np.random.default_rng(20)
    x = rng.standard_normal((B * T, N, D)).astype(np.float32)
    lns, lnb = _ln(21)
    wfc, bfc, wproj, bproj, w1, b1, w2, b2 = _weights(
        22, [(D, 4 * D), (4 * D,), (4 * D, D), (D,), (D, DH), (DH,), (DH, D), (D,)])
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jw = [_to_jax(w, jdt) for w in (wfc, bfc, wproj, bproj, w1, b1, w2, b2)]
    tw = [_to_torch(w, tdt) for w in (wfc.T, bfc, wproj.T, bproj, w1.T, b1, w2.T, b2)]
    with pltpu.force_tpu_interpret_mode():
        want = fused_joint_mlp_adapter(_to_jax(x, jdt), jnp.asarray(lns),
                                       jnp.asarray(lnb), *jw, 0.5)
    got = fused_joint(_to_torch(x, tdt), _to_torch(lns, torch.float32),
                      _to_torch(lnb, torch.float32), *tw, 0.5)
    _compare(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("gated", [False, True])
def test_joint_rows_matches_pallas(dtype, gated):
    """``fused_joint`` against ``fused_joint_mlp_rows``, ungated (eval
    ``joint_core="rows"``) and with a per-row gate of zeros and 1/keep."""
    rng = np.random.default_rng(23)
    x = rng.standard_normal((B * T, N, D)).astype(np.float32)
    lns, lnb = _ln(24)
    w = _weights(25, [(D, 4 * D), (4 * D,), (4 * D, D), (D,), (D, DH), (DH,),
                      (DH, D), (D,)])
    gate = (np.repeat(np.where(np.arange(B * T) % 3 == 1, 0.0, 1 / 0.9), N)
            .astype(np.float32) if gated else None)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    with pltpu.force_tpu_interpret_mode():
        want = fused_joint_mlp_rows(
            _to_jax(x, jdt), jnp.asarray(lns), jnp.asarray(lnb),
            *(_to_jax(a, jdt) for a in w), 0.5,
            gate=None if gate is None else jnp.asarray(gate))
    got = fused_joint(
        _to_torch(x, tdt), _to_torch(lns, torch.float32),
        _to_torch(lnb, torch.float32),
        *(_to_torch(a.T if a.ndim == 2 else a, tdt) for a in w), 0.5,
        None if gate is None else torch.from_numpy(gate))
    _compare(got, want, dtype)


def test_cpu_wrappers_take_plain_version_and_launch_nothing():
    """On CPU tensors each wrapper returns its plain version's result and
    its launch counter stays 0."""
    reset_launch_counts()
    _, targs = _attention_case(30, "bfloat16", B * T)
    torch.testing.assert_close(fused_spatial_step(*targs, HEADS, True),
                               fused_spatial_step_plain(*targs, HEADS, True),
                               rtol=0, atol=0)
    torch.testing.assert_close(fused_temporal_step(*targs, T, HEADS, False),
                               fused_temporal_step_plain(*targs, T, HEADS, False),
                               rtol=0, atol=0)
    x, lns, lnb = targs[:3]
    w = [_to_torch(a, torch.bfloat16) for a in _weights(
        31, [(4 * D, D), (4 * D,), (D, 4 * D), (D,), (DH, D), (DH,), (D, DH), (D,)])]
    torch.testing.assert_close(fused_joint(x, lns, lnb, *w, 0.5),
                               fused_joint_plain(x, lns, lnb, *w, 0.5),
                               rtol=0, atol=0)
    counts = launch_counts()
    assert {"fused_temporal_step", "fused_spatial_step", "fused_joint"} <= set(counts)
    assert all(n == 0 for n in counts.values()), counts


@pytest.mark.parametrize("case", ["rank", "weight_shape", "frames", "device"])
def test_wrappers_reject_bad_arguments(case):
    _, targs = _attention_case(40, "float32", B * T)
    targs = list(targs)
    if case == "rank":
        targs[0] = targs[0].reshape(B * T * N, D)
    elif case == "weight_shape":
        targs[3] = targs[3][:, :-1]
    elif case == "device":
        targs[3] = targs[3].to("meta")
    with pytest.raises(ValueError):
        if case == "frames":
            fused_temporal_step(*targs, 3, HEADS, False)  # 8 rows, T=3
        else:
            fused_spatial_step(*targs, HEADS, True)
