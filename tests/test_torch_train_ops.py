"""The port's three train ops against the JAX package's Pallas train ops.

The same seeded numpy inputs and output cotangent go through the JAX op
under ``jax.vjp`` (Mosaic interpret mode inside ``jax.jit``, as
``tests/test_ops/test_frozen_backwards.py`` runs it on the CPU) and through
the port's autograd op on CPU tensors, which takes the plain forward and
backward. Output, dx and the adapter cotangents (dW1, db1, dW2, db2) are
compared, with drop-path gates that hold zeros and 1/keep. Weights are
handed over in each package's layout: (in, out) for JAX, (out, in) for the
port. Geometry: the toy of ``tests/test_torch_ops.py`` (B=2, T=4, N=5,
D=128, 2 heads of 64, adapter width 32).

Tolerances (measured on a CPU in brackets):
* fp32: only the fp32 summation order differs [output and dx up to 5e-6,
  dW up to 3e-5 at values up to ~27: a weight cotangent sums 40 rows whose
  terms cancel]. Bound 2e-5 relative + 2e-5 times the largest |ref| (at
  least 2e-5) absolute; the erf GELU in place of tanh moves dx and dW by
  ~1e-3 of their scale. An omitted cast is invisible at fp32, which is
  what the bf16 cases are for.
* bf16: both sides round the same intermediates (LN output, q/k/v, P, dS,
  dq/dk/dv, u, dpre, a, the gated cotangent, dx), so only a summation-order
  flip across a rounding boundary can move a value, by a bf16 ulp (2**-8
  to 2**-7 of it), and the flip can travel through the later products of
  the backward [bit-equal but for a few elements one ulp apart: up to
  7.8e-3 in dx and 3.1e-2 in dW at values of 4 and 12]. Bound
  2**-6 * |ref| + 2e-3 elementwise and 2e-4 on the mean absolute error
  relative to the mean magnitude. Checked on broken copies of the code:
  leaving out the bf16 cast of the gated cotangent before the W_2 product
  fails, and so does the erf GELU in place of tanh; rounding P to bf16
  inside the row sum of dP * P moves values by less than the bounds at
  this size and passes.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.ops.fused_joint_mlp import fused_joint_train_block as jax_joint
from adapt_image_models_tpu.ops.fused_qkv_attention import (
    fused_spatial_train_step as jax_spatial,
)
from adapt_image_models_tpu.ops.fused_temporal_attention import (
    fused_temporal_train_step as jax_temporal,
)
from adapt_image_models_torch.ops import (
    fused_joint_train_block, fused_spatial_train_step, fused_temporal_train_step,
    launch_counts, reset_launch_counts,
)

B, T, N, D, HEADS = 2, 4, 5, 128, 2
DH = D // 4
SCALE = 0.5
KEEP = 0.9

FP32_TOL = 2e-5
BF16_RTOL, BF16_ATOL, BF16_MEAN_REL = 2 ** -6, 2e-3, 2e-4


def _rand(rng, shape, s):
    return (s * rng.standard_normal(shape)).astype(np.float32)


def _case(seed, kind):
    """numpy inputs: x, LN, the four frozen tensors (JAX layout), the
    adapter (JAX layout), the frame-row gate and the output cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * T, N, D)).astype(np.float32)
    ln = ((1 + 0.1 * rng.standard_normal(D)).astype(np.float32),
          _rand(rng, D, 0.1))
    wide = 4 * D if kind == "joint" else 3 * D
    frozen = (_rand(rng, (D, wide), 0.05), _rand(rng, wide, 0.05),
              _rand(rng, (wide if kind == "joint" else D, D), 0.05),
              _rand(rng, D, 0.05))
    # adapter pre-activations of O(1), where the tanh and erf GELUs differ
    adapter = (_rand(rng, (D, DH), 0.3), _rand(rng, DH, 0.05),
               _rand(rng, (DH, D), 0.1), _rand(rng, D, 0.05))
    gate = np.where(np.arange(B * T) % 3 == 1, 0.0, 1.0 / KEEP).astype(np.float32)
    g = rng.standard_normal((B * T, N, D)).astype(np.float32)
    return x, ln, frozen, adapter, gate, g


def _jax_run(kind, dtype, x, ln, frozen, adapter, gate, g, skip,
             spatial_gate=False):
    jdt = jnp.dtype(dtype)
    cast = lambda a: jnp.asarray(a).astype(jdt)
    lns, lnb = (jnp.asarray(a) for a in ln)
    fz = [cast(a) for a in frozen]
    ad = [cast(a) for a in adapter]

    if kind == "temporal":
        def f(x, w1, b1, w2, b2):
            return jax_temporal(x, lns, lnb, *fz, w1, b1, w2, b2,
                                jnp.asarray(gate), T, HEADS, skip)
    elif kind == "spatial":
        def f(x, w1, b1, w2, b2):
            return jax_spatial(x, lns, lnb, *fz, w1, b1, w2, b2,
                               jnp.asarray(gate) if spatial_gate else None,
                               HEADS, skip, None)
    else:
        rows = jnp.asarray(np.repeat(gate, N))

        def f(x, w1, b1, w2, b2):
            return jax_joint(x, lns, lnb, *fz, w1, b1, w2, b2, rows, SCALE)

    def run(x, w1, b1, w2, b2, g):
        y, vjp = jax.vjp(f, x, w1, b1, w2, b2)
        return (y, *vjp(g))

    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(run)(cast(x), *ad, cast(g))
    y, dx, dw1, db1, dw2, db2 = (np.asarray(jnp.asarray(a, jnp.float32)) for a in out)
    return {"out": y, "dx": dx, "dW1": dw1.T, "db1": db1, "dW2": dw2.T, "db2": db2}


def _torch_run(kind, dtype, x, ln, frozen, adapter, gate, g, skip,
               spatial_gate=False):
    tdt = getattr(torch, dtype)
    t = lambda a, dt=tdt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)
    xt = t(x).requires_grad_()
    lns, lnb = (t(a, torch.float32) for a in ln)
    w, bw, w2_, b2_ = frozen
    fz = (t(w.T), t(bw), t(w2_.T), t(b2_))
    ad = [t(adapter[0].T), t(adapter[1]), t(adapter[2].T), t(adapter[3])]
    for p in ad:
        p.requires_grad_()
    gt = torch.from_numpy(gate)
    if kind == "temporal":
        y = fused_temporal_train_step(xt, lns, lnb, *fz, *ad, gt, T, HEADS, skip)
    elif kind == "spatial":
        y = fused_spatial_train_step(xt, lns, lnb, *fz, *ad,
                                     gt if spatial_gate else None, HEADS, skip)
    else:
        y = fused_joint_train_block(xt, lns, lnb, *fz, *ad,
                                    gt.repeat_interleave(N), SCALE)
    y.backward(t(g))
    grads = [xt.grad] + [p.grad for p in ad]
    assert all(gr.dtype == tdt for gr in grads)
    f = lambda a: a.detach().float().numpy()
    return {"out": f(y), "dx": f(grads[0]), "dW1": f(grads[1]), "db1": f(grads[2]),
            "dW2": f(grads[3]), "db2": f(grads[4])}


def _compare(got, want, dtype):
    for name in want:
        a, b = got[name], want[name]
        assert a.shape == b.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=FP32_TOL,
                                       atol=FP32_TOL * max(1.0, np.abs(b).max()),
                                       err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=BF16_RTOL, atol=BF16_ATOL,
                                       err_msg=name)
            assert np.abs(a - b).mean() <= BF16_MEAN_REL * np.abs(b).mean(), name


CASES = [("temporal", False), ("spatial", True), ("joint", False)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind,skip", CASES)
def test_train_op_matches_pallas(kind, skip, dtype):
    """Forward, dx and the adapter cotangents against the JAX train op."""
    case = _case({"temporal": 0, "spatial": 1, "joint": 2}[kind], kind)
    want = _jax_run(kind, dtype, *case, skip)
    got = _torch_run(kind, dtype, *case, skip)
    _compare(got, want, dtype)


def test_temporal_train_op_with_adapter_skip_and_no_gate():
    """The temporal op's other branches: the adapter skip, and gate=None."""
    x, ln, frozen, adapter, _, g = _case(3, "temporal")
    gate = np.ones(B * T, np.float32)
    want = _jax_run("temporal", "float32", x, ln, frozen, adapter, gate, g, True)
    got = _torch_run("temporal", "float32", x, ln, frozen, adapter, gate, g, True)
    _compare(got, want, "float32")
    tdt = torch.float32
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(tdt)
    args = (t(x), *(t(a) for a in ln), t(frozen[0].T), t(frozen[1]),
            t(frozen[2].T), t(frozen[3]), *(t(a.T) if a.ndim == 2 else t(a)
                                            for a in adapter))
    torch.testing.assert_close(
        fused_temporal_train_step(*args, None, T, HEADS, True),
        fused_temporal_train_step(*args, torch.ones(B * T), T, HEADS, True),
        rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["temporal", "spatial", "joint"])
def test_frozen_weights_get_no_gradient(kind):
    """The frozen LN and CLIP weights get no cotangent on either side: JAX
    returns zeros for them, the port none; and the CPU path launches no
    kernel."""
    x, ln, frozen, adapter, gate, g = _case(4, kind)
    lns, lnb = jnp.asarray(ln[0]), jnp.asarray(ln[1])
    fz = [jnp.asarray(a) for a in frozen]
    ad = [jnp.asarray(a) for a in adapter]
    rows = jnp.asarray(np.repeat(gate, N))

    def loss(lns, w):
        if kind == "temporal":
            y = jax_temporal(jnp.asarray(x), lns, lnb, w, *fz[1:], *ad,
                             jnp.asarray(gate), T, HEADS, False)
        elif kind == "spatial":
            y = jax_spatial(jnp.asarray(x), lns, lnb, w, *fz[1:], *ad, None,
                            HEADS, True, None)
        else:
            y = jax_joint(jnp.asarray(x), lns, lnb, w, *fz[1:], *ad, rows, SCALE)
        return jnp.sum(y * jnp.asarray(g))

    with pltpu.force_tpu_interpret_mode():
        d_ln, d_w = jax.jit(jax.grad(loss, argnums=(0, 1)))(lns, fz[0])
    assert float(jnp.abs(d_ln).max()) == 0.0 and float(jnp.abs(d_w).max()) == 0.0

    reset_launch_counts()
    frozen_t = [torch.from_numpy(np.ascontiguousarray(a.T if a.ndim == 2 else a))
                for a in frozen]
    ln_t = [torch.from_numpy(a) for a in ln]
    _torch_run(kind, "float32", x, ln, frozen, adapter, gate, g,
               kind == "spatial")
    assert all(p.grad is None for p in frozen_t + ln_t)
    assert all(n == 0 for n in launch_counts().values())


@pytest.mark.parametrize("kind", ["temporal", "spatial", "joint"])
def test_frozen_weight_that_requires_grad_raises(kind):
    x, ln, frozen, adapter, gate, _ = _case(5, kind)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    fz = [t(frozen[0].T).requires_grad_(), t(frozen[1]), t(frozen[2].T), t(frozen[3])]
    ad = [t(adapter[0].T), t(adapter[1]), t(adapter[2].T), t(adapter[3])]
    args = (t(x), t(ln[0]), t(ln[1]), *fz, *ad)
    with pytest.raises(ValueError, match="frozen"):
        if kind == "temporal":
            fused_temporal_train_step(*args, t(gate), T, HEADS, False)
        elif kind == "spatial":
            fused_spatial_train_step(*args, None, HEADS, True)
        else:
            fused_joint_train_block(*args, t(gate).repeat_interleave(N), SCALE)


def test_gated_spatial_step_matches_jax():
    """The spatial train op with a drop-path gate: at this geometry both
    packages run their whole-step backward with the gate (the JAX forward
    is the gated kernel, :1557), and output, dx and the adapter cotangents
    agree as in the ungated case."""
    case = _case(6, "spatial")
    want = _jax_run("spatial", "bfloat16", *case, True, spatial_gate=True)
    got = _torch_run("spatial", "bfloat16", *case, True, spatial_gate=True)
    _compare(got, want, "bfloat16")
    x16 = torch.from_numpy(case[0]).bfloat16().float().numpy()
    assert np.array_equal(got["out"][1], x16[1])  # row 1's gate is 0
