"""The 3D CNN backbones of the PyTorch port against the JAX package:
ResNet3d (I3D), ResNet3dSlowOnly, ResNet3dCSN, ResNet3dLayer, C3D and
ResNet2Plus1d under ``Recognizer3D`` with the I3D head, and the TF "SAME"
padding of the strided, dilated and depthwise 3D convs and pools, where
torch's symmetric ``padding`` would sit on the wrong grid.

The same seeded numpy inputs and weights go through both packages; the JAX
``variables`` (params and batch_stats, the BatchNorms' scales, biases and
statistics drawn away from their constants) convert with
``params_from_jax`` and load strictly. Toy geometry: base width 8, one or
two blocks a stage, 2 clips of 4-16 frames at 32² (33² where odd sizes
matter); C3D at its own widths on 16 x 112² (eval) and 16 x 32². Each
recognizer case holds the eval forward to JAX, then the train-mode forward,
the running statistics it leaves and every tensor's gradient of both
packages to the port's float64 evaluation of the same weights, as
``tests/test_torch_resnet2d.py`` does.

Tolerances (CPU readings in brackets). Eval logits and backbone maps 2e-5
of their largest magnitude [1.4e-6 at most over the recognizer cases of
this file and ``tests/test_torch_slowfast_x3d.py``]; SAME convs 1e-5
[1.4e-6], pools bit-equal. Train mode, per tensor sum|diff| / sum|ref| against float64:
JAX's logits within 5e-4, statistics 1e-4, gradients 1e-2 (1e-1 through a
non-local block); the port's within 1.5x of JAX's largest gap.
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models.builder import BACKBONES as JAX_BACKBONES
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.builder import build_backbone
from adapt_image_models_torch.models.layers import conv3d_same, max_pool3d_same, same_pads

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import (
    _clips, _draw, _gaps, _np, _rel, _train_loss, jax_variables, zero_gradient,
)

CLASSES = 5
TOY = dict(base_channels=8, stage_blocks=(1, 1, 1, 1))


def recognizer_cfg(backbone, in_channels):
    return dict(type="Recognizer3D", backbone=backbone,
                cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=in_channels,
                              dropout_ratio=0.0))


def port_cfg(cfg, **backbone):
    """The port's config of a JAX one: the sizes flax infers from the input
    and torch needs at construction (``in_channels``, C3D's
    ``clip_size``)."""
    return dict(cfg, backbone={**cfg["backbone"], **backbone})


def port_model(cfg, variables, **backbone):
    model = build_model(port_cfg(cfg, **backbone))
    model.load_state_dict(params_from_jax(variables), strict=True)
    return model


# name: (JAX recognizer config, input shape, the port's extra backbone keys)
CASES = {
    # per-block inflate tuples (entry j % length), an even-T (5, 7, 7)/2 stem
    "i3d_inflate": (recognizer_cfg(dict(
        type="ResNet3d", depth=50, base_channels=8, stage_blocks=(2, 2, 1, 1),
        conv1_kernel=(5, 7, 7), inflate=((1, 0), (0, 1, 0), 1, 0)), 256),
        (2, 3, 8, 32, 32), {}),
    # the 3x3x3 style, with_pool2, a dilation of 2 on odd sizes
    "i3d_333_pool2_dilation": (recognizer_cfg(dict(
        type="ResNet3d", depth=50, inflate_style="3x3x3", with_pool2=True,
        dilations=(1, 1, 2, 2), spatial_strides=(1, 2, 2, 1), **TOY), 256),
        (2, 3, 8, 33, 33), {}),
    "r18_basic_dilation": (recognizer_cfg(dict(
        type="ResNet3d", depth=18, with_pool2=True, dilations=(1, 2, 1, 2),
        inflate=(1, 0, 1, 0), **TOY), 64), (2, 3, 8, 64, 64), {}),
    # stage-level non-local blocks (an int flag a stage)
    "slowonly_nl_stage": (recognizer_cfg(dict(
        type="ResNet3dSlowOnly", depth=50, non_local=(0, 1, 1, 0),
        non_local_cfg=dict(mode="embedded_gaussian", sub_sample=True, use_scale=True,
                           norm_cfg=dict(type="BN3d", requires_grad=True)), **TOY), 256),
        (2, 3, 4, 32, 32), {}),
    # per-block non-local flags
    "slowonly_nl_block": (recognizer_cfg(dict(
        type="ResNet3dSlowOnly", depth=50, base_channels=8, stage_blocks=(1, 2, 1, 1),
        non_local=((0,), (1, 0), (1,), (0,)),
        non_local_cfg=dict(mode="dot_product", sub_sample=True)), 256),
        (2, 3, 4, 32, 32), {}),
    "csn_ir": (recognizer_cfg(dict(type="ResNet3dCSN", depth=50, bottleneck_mode="ir",
                                   **TOY), 256), (2, 3, 8, 32, 32), {}),
    "csn_ip": (recognizer_cfg(dict(type="ResNet3dCSN", depth=50, bottleneck_mode="ip",
                                   **TOY), 256), (2, 3, 8, 33, 33), {}),
    "r2plus1d": (recognizer_cfg(dict(type="ResNet2Plus1d", stage_blocks=(1, 1, 1, 1)), 512),
                 (2, 3, 4, 32, 32), {}),
    # C3D at 16 x 32² (fc6 of 512·1·2·2 inputs): the train-mode case
    "c3d_32": (recognizer_cfg(dict(type="C3D", dropout_ratio=0.0), 4096),
               (2, 3, 16, 32, 32), dict(clip_size=(16, 32, 32))),
}


def _case(name):
    cfg, shape, extra = CASES[name]
    jmodel, variables = jax_variables(cfg, shape)
    return cfg, shape, extra, jmodel, variables


# ---- SAME padding of the 3D convs and pools ------------------------------------

CONVS = [
    # (T, H, W), kernel, stride, dilation, depthwise
    ((32, 16, 16), (5, 7, 7), (2, 2, 2), (1, 1, 1), False),  # I3D's stem, T pads (1, 2)
    ((8, 16, 16), (3, 3, 3), (1, 2, 2), (1, 1, 1), True),  # X3D's depthwise, H pads (0, 1)
    ((32, 4, 4), (5, 1, 1), (8, 1, 1), (1, 1, 1), False),  # SlowFast lateral, alpha 8
    ((32, 4, 4), (5, 1, 1), (4, 1, 1), (1, 1, 1), False),  # alpha 4: T pads (0, 1)
    ((4, 9, 9), (1, 3, 3), (1, 1, 1), (1, 2, 2), False),  # dilation 2
    ((5, 15, 14), (3, 3, 3), (2, 2, 2), (1, 2, 2), True),  # dilated, strided, odd
]


@pytest.mark.parametrize("size,kernel,stride,dilation,depthwise", CONVS)
def test_conv3d_same_matches_flax(size, kernel, stride, dilation, depthwise):
    """conv3d_same (with a bias) against flax's padding="SAME" nn.Conv of
    the same strides, kernel dilation and feature groups."""
    rng = np.random.default_rng(sum(size))
    c = 4
    x = rng.standard_normal((2, c) + size).astype(np.float32)
    w = rng.standard_normal(kernel + (1 if depthwise else c, c)).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    conv = fnn.Conv(c, kernel, stride, kernel_dilation=dilation,
                    feature_group_count=c if depthwise else 1)
    want = conv.apply({"params": {"kernel": jnp.asarray(w), "bias": jnp.asarray(b)}},
                      jnp.asarray(np.moveaxis(x, 1, -1)))
    got = conv3d_same(torch.tensor(x), torch.tensor(w.transpose(4, 3, 0, 1, 2)),
                      torch.tensor(b), stride, dilation, c if depthwise else 1)
    assert _rel(got, np.moveaxis(_np(want), -1, 1)) < 1e-5
    assert same_pads(32, 5, 2) == (1, 2) and same_pads(16, 3, 2) == (0, 1)
    assert same_pads(32, 5, 8) == (0, 0) and same_pads(32, 5, 4) == (0, 1)
    assert same_pads(9, 5, 1) == (2, 2)  # a (3)-kernel at dilation 2


@pytest.mark.parametrize("size,kernel,stride", [
    ((4, 16, 16), (1, 3, 3), (1, 2, 2)), ((4, 15, 15), (1, 3, 3), (1, 2, 2)),
    ((8, 5, 5), (1, 3, 3), (2, 2, 2)), ((8, 4, 4), (2, 1, 1), (2, 1, 1)),
    ((5, 4, 4), (2, 1, 1), (2, 1, 1))])
def test_max_pool3d_same_matches_flax(size, kernel, stride):
    """max_pool3d_same against flax's -inf padded SAME max pool, bit for
    bit: the stems' (1, 3, 3) pools (temporal stride 1 and 2) and
    with_pool2's (2, 1, 1) on even and odd T."""
    x = np.random.default_rng(3).standard_normal((2, 3) + size).astype(np.float32)
    want = fnn.max_pool(jnp.asarray(np.moveaxis(x, 1, -1)), kernel, stride, padding="SAME")
    got = max_pool3d_same(torch.tensor(x), kernel, stride)
    np.testing.assert_array_equal(got.numpy(), np.moveaxis(_np(want), -1, 1))


# ---- the recognizer ---------------------------------------------------------------

def assert_train_mode_close(cfg, extra, variables, jmodel, x, nl=False):
    """A train-mode forward (batch statistics), the running statistics it
    leaves and every tensor's gradient: JAX's fp32 within the bounds of the
    port's float64 evaluation, the port's fp32 within 1.5x of JAX's largest
    gap (``tests/test_torch_resnet2d.py::test_recognizer2d_matches_jax``)."""
    labels = np.arange(x.shape[0]) % CLASSES
    (_, (want, mut)), grads = _train_loss(jmodel, variables, jnp.asarray(x), labels)
    model = port_model(cfg, variables, **extra)
    cfg64 = dict(cfg, backbone=dict(cfg["backbone"], compute_dtype="float64"))
    runs = {}
    for key, m, inp in (("port", model, torch.tensor(x)),
                        ("f64", port_model(cfg64, variables, **extra).double(),
                         torch.tensor(x).double())):
        m.train()
        logits = m(inp)
        torch.nn.functional.cross_entropy(logits, torch.tensor(labels)).backward()
        runs[key] = {"logits": logits.detach(), **{n: p.grad for n, p in m.named_parameters()},
                     **{k: v for k, v in m.state_dict().items() if "running" in k}}
    jax_run = {"logits": torch.tensor(np.asarray(want)), **params_from_jax(grads),
               **params_from_jax({"params": {}, "batch_stats": mut.get("batch_stats", {})})}
    assert set(jax_run) == set(runs["port"])
    ref = runs["f64"]
    top = max(float(ref[n].abs().max()) for n, _ in model.named_parameters())
    port_gap, jax_gap = _gaps(runs["port"], ref, 1e-6 * top), _gaps(jax_run, ref, 1e-6 * top)
    groups = {"logits": ["logits"], "statistics": [k for k in ref if "running" in k],
              "gradients": [n for n, _ in model.named_parameters() if not zero_gradient(n, cfg)]}
    for group, bound in (("logits", 5e-4), ("statistics", 1e-4),
                         ("gradients", 1e-1 if nl else 1e-2)):
        if not groups[group]:
            continue
        worst_jax = max(jax_gap[n] for n in groups[group])
        worst_port = max(port_gap[n] for n in groups[group])
        assert worst_jax < bound, group
        assert worst_port <= 1.5 * worst_jax + 1e-7, group


@pytest.mark.parametrize("name", list(CASES))
def test_recognizer3d_cnn_matches_jax(name):
    """The eval forward against JAX (2e-5), then the train-mode forward,
    statistics and gradients against the float64 arbiter."""
    cfg, shape, extra, jmodel, variables = _case(name)
    model = port_model(cfg, variables, **extra).eval()
    x = _clips(shape, 5)
    with torch.no_grad():
        assert _rel(model(torch.tensor(x)), jax.jit(jmodel.apply)(variables, jnp.asarray(x))) < 2e-5
    assert_train_mode_close(cfg, extra, variables, jmodel, x,
                            nl="non_local" in cfg["backbone"])


def test_c3d_full_clip_matches_jax():
    """C3D as shipped at 16 x 112² (fc6 of 8192 inputs, flattened
    channels-last as JAX's), through the I3D head on its (B, 4096)
    features: the eval logits and features against JAX; another grid
    raises ValueError."""
    cfg = recognizer_cfg(dict(type="C3D"), 4096)
    shape = (1, 3, 16, 112, 112)
    jmodel, variables = jax_variables(cfg, shape)
    model = port_model(cfg, variables).eval()
    assert model.backbone.fc6.in_features == 8192
    x = _clips(shape, 6)
    with torch.no_grad():
        got = model(torch.tensor(x))
        feats = model.extract_feat(torch.tensor(x))
    assert feats.shape == (1, 4096)
    assert _rel(got, jmodel.apply(variables, jnp.asarray(x))) < 2e-5
    assert _rel(feats, jmodel.apply(variables, jnp.asarray(x), method=jmodel.extract_feat)) < 2e-5
    with pytest.raises(ValueError):
        model(torch.zeros(1, 3, 16, 128, 128))


def test_recognizer3d_cnn_bf16_matches_jax():
    """compute_dtype bfloat16: the convs in bf16, every BatchNorm's output
    fp32, the logits near JAX's (3e-2 of the largest)."""
    cfg, shape, extra = CASES["csn_ip"]
    cfg = dict(cfg, backbone=dict(cfg["backbone"], compute_dtype="bfloat16"))
    jcfg = dict(cfg, backbone=dict(cfg["backbone"], compute_dtype=jnp.bfloat16))
    jmodel, variables = jax_variables(jcfg, shape)
    model = port_model(cfg, variables).eval()
    x = _clips(shape, 7)
    with torch.no_grad():
        got = model(torch.tensor(x))
    assert got.dtype == torch.float32
    assert _rel(got, jmodel.apply(variables, jnp.asarray(x))) < 3e-2


# ---- backbones alone ---------------------------------------------------------------

def backbone_pair(bb, shape, seed=0, **extra):
    """The JAX backbone of ``bb``, its seeded variables, and the port's
    backbone loaded with them."""
    jbb = JAX_BACKBONES.build(dict(bb))
    tree = jax.eval_shape(jbb.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    bvars = _draw(tree, seed)
    port = build_backbone({**bb, **extra})
    sd = params_from_jax({"params": {"backbone_module": bvars["params"]},
                          "batch_stats": {"backbone_module": bvars.get("batch_stats", {})}})
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()}, strict=True)
    return jbb, bvars, port.eval()


BACKBONES = {
    # the stage-level class: the core at one stage, its stem included
    "layer": (dict(type="ResNet3dLayer", depth=50, base_channels=8, stage_blocks=(2,)),
              (2, 3, 4, 32, 32), {}),
    # two out_indices: the tuple of those stages' channels-last maps
    "out_indices": (dict(type="ResNet3dSlowOnly", depth=18, out_indices=(1, 3), **TOY),
                    (2, 3, 4, 32, 32), {}),
    # the posec3d backbone (skeleton/posec3d/slowonly_r50_u48_*) at base 8,
    # one block a stage, on 17 heatmap channels
    "posec3d": (dict(type="ResNet3dSlowOnly", depth=50, in_channels=17, base_channels=8,
                     num_stages=3, out_indices=(2,), stage_blocks=(1, 1, 1),
                     conv1_stride_s=1, pool1_stride_s=1, inflate=(0, 1, 1),
                     spatial_strides=(2, 2, 2), temporal_strides=(1, 1, 2),
                     dilations=(1, 1, 1)), (2, 17, 8, 28, 28), {}),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_backbone_maps_match_jax(name):
    """Eval maps of the backbones a head does not take whole: channels-last
    fp32, each within 2e-5 of JAX's."""
    bb, shape, extra = BACKBONES[name]
    jbb, bvars, port = backbone_pair(bb, shape, **extra)
    x = _clips(shape, 8)
    with torch.no_grad():
        got = port(torch.tensor(x))
    want = jbb.apply(bvars, jnp.asarray(x))
    got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == tuple(w.shape)
        assert _rel(g, w) < 2e-5
    if name == "posec3d":
        assert got[0].shape == (2, 4, 4, 4, 128)


def test_backbone_keys_refused():
    """A key the JAX class lacks raises; an unknown depth raises KeyError,
    as the JAX table's lookup does."""
    with pytest.raises(TypeError):
        build_backbone(dict(type="ResNet3d", depth=50, no_such_key=1), device="meta")
    with pytest.raises(KeyError):
        build_backbone(dict(type="ResNet3d", depth=42), device="meta")
    bb = build_backbone(dict(type="ResNet3dCSN", depth=152, bottleneck_mode="ip",
                             pretrained="x", pretrained2d=False, lateral=False,
                             bn_frozen=True), device="meta")
    assert bb.layer1[0].conv2.groups == 64 and bb.layer1[0].conv2_ip is not None
