"""The port's model-running layer against the JAX package: the eval step
ops' gradient, GradCAM, ``torch.export`` of a recognizer, the kernels as
registered ops (``aim_port::*``) and the FLOP count over them.

* The eval step ops (``fused_spatial_step``, ``fused_temporal_step``,
  ``fused_joint``) take the gradient of the JAX package's ``custom_vjp``
  steps (``fused_*_block``: ``jax.vjp`` of the XLA reference), through
  ``RecomputedVjp`` on every device; JAX runs its Pallas forward in
  interpret mode. fp32: ``test_torch_ops.py``'s 2e-5 times the largest
  cotangent [at most 7.6e-6 where the largest is 40]. bf16: both sides
  differentiate the XLA reference, whose every framework op rounds to bf16
  and which XLA and PyTorch sum and round in other orders (the reason of
  ``test_torch_model.py``'s "xla" bf16 bound), so 2**-6 of the value plus
  2**-6 of the largest elementwise and 2**-9 of the largest on the mean
  [3.1e-2 at most, where the largest is 16.25 (half an ulp there); mean
  at most 9.5e-4].
* GradCAM on ``tests/test_runtime/test_utils_apis.py``'s tiny AIM (width
  32, 2 heads, one layer, 4 frames, 3 classes) with seeded adapters, under
  ``"xla"`` and ``"fused"`` (JAX interpret mode; the port's plain versions
  on the CPU): CAM and probabilities within 1e-5 [4.2e-7 and 3.0e-8].
* Export: the toy of ``test_torch_model.py`` (fp32) exported, saved,
  loaded and run bit for bit as the eager model, and within 2e-5 of
  JAX's ``jax.export`` of the same weights; on the meta device the fused
  bf16 toy's graph holds the kernels as ``aim_port`` ops.
* ``torch.library.opcheck`` of every registered op on small CPU inputs
  (schema, fake implementation, dispatch); the meta-device FLOP count of a
  fused toy equals that of the ``"xla"`` toy.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from jax import export as jexport
from jax.experimental.pallas import tpu as pltpu

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.ops.fused_joint_mlp import fused_joint_block
from adapt_image_models_tpu.ops.fused_qkv_attention import fused_spatial_step_block
from adapt_image_models_tpu.ops.fused_temporal_attention import fused_temporal_step_block
from adapt_image_models_tpu.utils.gradcam import gradcam as jax_gradcam
from adapt_image_models_torch.apis.test import artifact_input_shape
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.ops import _kernels, fused_joint, fused_spatial_step, fused_temporal_step
from adapt_image_models_torch.utils.flops import count_flops
from adapt_image_models_torch.utils.gradcam import gradcam

from test_torch_model import _cfg, _port, _randomize
from test_torch_ops import (
    B, D, DH, FP32_TOL, HEADS, N, T, _attention_case, _ln, _to_jax, _to_torch, _weights,
)
from test_torch_tools_cli import load_tool

# ---------------------------------------------------------------------------
# the eval step ops' gradient


def _joint_case(seed, dtype):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B * T, N, D)).astype(np.float32)
    lns, lnb = _ln(seed + 1)
    ws = _weights(seed + 2, [(D, 4 * D), (4 * D,), (4 * D, D), (D,), (D, DH), (DH,), (DH, D),
                             (D,)])
    ws[4], ws[6] = 6 * ws[4], 2 * ws[6]  # adapter pre-activations of O(1)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jargs = (_to_jax(x, jdt), jnp.asarray(lns), jnp.asarray(lnb), *(_to_jax(w, jdt) for w in ws))
    targs = (_to_torch(x, tdt), _to_torch(lns, torch.float32), _to_torch(lnb, torch.float32),
             *(_to_torch(w.T if w.ndim == 2 else w, tdt) for w in ws))
    return jargs, targs


STEPS = {  # op: (JAX custom_vjp block, port op, trailing arguments, case)
    "spatial": (fused_spatial_step_block, fused_spatial_step, (HEADS, True),
                lambda dt: _attention_case(30, dt, B * T)),
    "temporal": (fused_temporal_step_block, fused_temporal_step, (T, HEADS, False),
                 lambda dt: _attention_case(40, dt, B * T)),
    "joint": (fused_joint_block, fused_joint, (0.5,), lambda dt: _joint_case(50, dt)),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("op", sorted(STEPS))
def test_eval_step_gradient_matches_jax_custom_vjp(op, dtype):
    """dx and the adapter cotangents of the port's eval step op against
    ``jax.vjp`` of JAX's ``fused_*_block`` for one seeded cotangent; the
    output's ``grad_fn`` is the ``RecomputedVjp`` node."""
    jax_block, port_op, rest, case = STEPS[op]
    jargs, targs = case(dtype)
    cot = np.random.default_rng(60).standard_normal(jargs[0].shape).astype(np.float32)

    def jfn(x, w1, b1, w2, b2):
        return jax_block(x, *jargs[1:7], w1, b1, w2, b2, *rest)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jfn, jargs[0], *jargs[7:11])
        want = vjp(_to_jax(cot, jnp.dtype(dtype)))
    leaves = [t.clone().requires_grad_() for t in (targs[0], *targs[7:11])]
    out = port_op(leaves[0], *targs[1:7], *leaves[1:], *rest)
    assert type(out.grad_fn).__name__ == "RecomputedVjpBackward"
    got = torch.autograd.grad(out, leaves, _to_torch(cot, out.dtype))
    for name, g, w in zip(("dx", "dW1", "db1", "dW2", "db2"), got, want):
        g = g.float().numpy()
        w = np.asarray(jnp.asarray(w, jnp.float32))
        g = g.T if g.ndim == 2 else g  # torch (out, in), JAX (in, out)
        scale = max(1.0, float(np.abs(w).max()))
        err = np.abs(g - w)
        if dtype == "float32":
            assert err.max() <= FP32_TOL * scale, name
        else:
            assert (err <= 2 ** -6 * (np.abs(w) + scale)).all(), name
            assert err.mean() <= 2 ** -9 * scale, name
    with torch.no_grad():
        assert port_op(*targs, *rest).grad_fn is None


# ---------------------------------------------------------------------------
# GradCAM


def _tiny_cfg(core):
    """``test_utils_apis.py``'s tiny AIM under ``core``."""
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=32, patch_size=16, width=32, layers=1,
                      heads=2, num_frames=4, attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=3, in_channels=32))


@pytest.mark.parametrize("core", ["xla", "fused"])
def test_gradcam_matches_jax(core):
    """``utils.gradcam.gradcam`` against ``adapt_image_models_tpu/utils/
    gradcam.py`` on the same seeded weights and clips: the (B, T, H, W)
    CAM and the (B, classes) probabilities, the top-1 class and a given
    target class."""
    x = np.random.default_rng(0).standard_normal((2, 3, 4, 32, 32)).astype(np.float32)
    jmodel = build_jax_model(_tiny_cfg(core))
    targets = (None, 1) if core == "xla" else (None,)  # interpret mode is slow
    with pltpu.force_tpu_interpret_mode():
        params = {"params": _randomize(
            jmodel.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)}
        want = [jax_gradcam(jmodel, params, jnp.asarray(x), target_class=k) for k in targets]
    model = build_model(_tiny_cfg(core))
    model.load_state_dict(params_from_jax(params["params"]), strict=True)
    for k, (want_cam, want_scores) in zip(targets, want):
        cam, scores = gradcam(model, torch.from_numpy(x), target_class=k, device="cpu")
        assert tuple(cam.shape) == (2, 4, 32, 32) and tuple(scores.shape) == (2, 3)
        np.testing.assert_allclose(cam.numpy(), np.asarray(want_cam), rtol=0, atol=1e-5)
        np.testing.assert_allclose(scores.numpy(), np.asarray(want_scores), rtol=0, atol=1e-5)
    assert all(p.requires_grad for p in model.parameters())
    with pytest.raises(ValueError):
        gradcam(model, torch.from_numpy(x), device="meta")


# ---------------------------------------------------------------------------
# torch.export and the registered ops

export_tool = load_tool("tools/deployment/export_torch.py")


@pytest.fixture(scope="module")
def jax_export_case():
    """Seeded weights of the toy, a batch of clips and the output of
    ``jax.export`` of JAX's ``"xla"`` model on them (an interpret-mode
    Pallas call does not serialise)."""
    jmodel = build_jax_model(_cfg("xla", "float32"))
    x = np.random.default_rng(5).standard_normal((2, 3, 4, 32, 32)).astype(np.float32)
    params = _randomize(jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 1)
    exported = jexport.export(jax.jit(lambda v: jmodel.apply({"params": params}, v)))(
        jax.ShapeDtypeStruct(x.shape, jnp.float32))
    return params, x, np.asarray(exported.call(jnp.asarray(x)))


@pytest.mark.parametrize("core", ["fused", "xla"])
def test_export_round_trip_matches_eager_and_jax_export(jax_export_case, core, tmp_path):
    """The toy (fp32; ``"fused"`` takes the plain versions on the CPU)
    exported at batch 2, saved as ``.pt2``, loaded and run: bit for bit the
    eager model, and within 2e-5 of JAX's ``jax.export`` artifact on the
    same weights [fused 1.6e-7, xla 3.0e-8 on logits of magnitude 0.1]."""
    params, x, want = jax_export_case
    model = _port(core, "float32", params)
    xt = torch.from_numpy(x)
    program = export_tool.export(model, xt)
    path = str(tmp_path / "toy.pt2")
    torch.export.save(program, path)
    assert not export_tool.kernel_ops(program)  # the CPU route: no kernel op
    _, got = export_tool.run_artifact(path, "cpu", xt)
    assert artifact_input_shape(torch.export.load(path)) == tuple(x.shape)
    with torch.no_grad():
        eager = model(xt)
    assert torch.equal(got, eager)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_meta_export_holds_the_kernels_as_registered_ops():
    """On the meta device the fused bf16 toy (head dim 64) takes the kernel
    route, whose launchers go through ``aim_port``: its exported graph
    holds three LayerNorms, twelve GEMMs, a spatial and a temporal core a
    layer, and runs no kernel."""
    from adapt_image_models_torch import ops
    model = build_model(_cfg("fused", "bfloat16"), device="meta").eval()
    ops.reset_launch_counts()
    program = export_tool.export(model, torch.empty(1, 3, 4, 32, 32, device="meta"))
    layers = _cfg("fused", "bfloat16")["backbone"]["layers"]
    assert export_tool.kernel_ops(program) == {
        "layernorm": 3 * layers, "gemm": 12 * layers, "spatial_attention": layers,
        "temporal_attention": layers}
    assert not any(ops.launch_counts().values())
    assert not any(ops.core_launch_counts().values())


def _op_cases():
    """(op, arguments) of every registered op on small CPU tensors."""
    g = torch.Generator().manual_seed(7)

    def r(*shape, dtype=torch.bfloat16):
        return torch.randn(*shape, generator=g).to(dtype)
    f32 = torch.float32
    d, frames, length, clips = 128, 4, 3, 2
    qkv_s = r(frames * length, 3 * d)
    qkv_t = r(clips * frames * length, 3 * d)
    rows = clips * frames * length
    return [
        ("layernorm", (r(5, 16), r(16, dtype=f32), r(16, dtype=f32), 1e-5)),
        ("layernorm_bwd", (r(5, 16), r(5, 16, dtype=f32), r(16, dtype=f32), r(5, 16), 1e-5)),
        ("layernorm_bwd", (r(5, 16), r(5, 16, dtype=f32), r(16, dtype=f32), None, 1e-5)),
        ("row_scale", (r(6, 16), r(3, dtype=f32), 2, 0.5)),
        ("gemm", (r(5, 32), r(16, 32), False, r(16), 0, None, 0, 1.0, None, None, 1, None, None,
                  True, True, False)),
        ("gemm", (r(5, 32), r(32, 16), True, None, 2, r(5, 16, dtype=f32), 1, 0.5,
                  r(5, 16, dtype=f32), r(5, dtype=f32), 1, r(5, 16), r(16), False, True,
                  False)),
        ("flash_attention", (r(1, 2, 5, 64), r(1, 2, 5, 64), r(1, 2, 5, 64), False)),
        ("spatial_attention", (qkv_s, frames, length, True)),
        ("spatial_attention_bwd", (qkv_s, r(frames * length, d), frames, length, True)),
        ("temporal_attention", (qkv_t, clips, frames, length)),
        ("temporal_attention_bwd", (qkv_t, r(rows, d), clips, frames, length, False)),
        ("temporal_segment", (qkv_t, clips, frames, length)),
        ("temporal_segment_bwd", (qkv_t, r(rows, d, dtype=f32), clips, frames, length, True)),
    ]


@pytest.mark.parametrize("name,args", _op_cases(),
                         ids=[f"{n}-{i}" for i, (n, _) in enumerate(_op_cases())])
def test_registered_op_passes_opcheck(name, args):
    """``torch.library.opcheck`` (schema, fake implementation against the
    CPU one, dispatch) of each ``aim_port`` op; its CPU implementation is
    the kernel's plain version."""
    assert set(_kernels._OPS) == {n for n, _ in _op_cases()}
    torch.library.opcheck(getattr(torch.ops.aim_port, name).default, args)


def test_flop_count_over_the_kernels_equals_the_xla_model():
    """On the meta device the fused bf16 toy's count (the ``aim_port`` ops'
    FLOP formulas) equals the ``"xla"`` toy's (aten's matmuls)."""
    shape = (2, 3, 4, 32, 32)
    counts = [count_flops(build_model(_cfg(core, "bfloat16"), device="meta").eval(), shape)
              for core in ("fused", "xla")]
    assert counts[0] == counts[1] > 0
