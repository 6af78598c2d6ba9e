"""The rest of the 2D segment models of the PyTorch port against the JAX
package: TRNHead (multi-scale and full-scale relations), ResNetTIN (its
``TemporalInterlace``, a 4-step SGD trajectory and the offsets' gradient
against a finite difference), MobileNetV2 and MobileNetV2TSM, TANet (with
``TAM``, whose ``g_bn`` normalises the last axis) and DenseNet, each in
``Recognizer2D``.

Seeded JAX variables (``test_torch_resnet2d._draw``) convert with
``params_from_jax``. Toys: ResNetTIN-18 over 4 segments of 64², TANet-50,
MobileNetV2 at widen 0.5 and DenseNet-121 at ``stage_blocks=(1, 2, 2, 1)``
over 4 segments of 32², 2 clips.

Tolerances (CPU readings in brackets): eval logits and segment features
1e-5 of the largest magnitude [1.3e-6]; train mode is held to the port's
float64 evaluation, the arbiter, as tests/test_torch_resnet2d.py holds the CNNs (JAX's fp32
train-mode results are the less accurate; bounds in each test); the
offsets' gradient against a central difference in float64 1e-6 relative
[3.0e-10].
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.heads.trn_head import _relation_subsets as jax_subsets
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones.resnet_tin import TemporalInterlace
from adapt_image_models_torch.models.heads.trn_head import _relation_subsets

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _draw, _rel, _sum_rel
from test_torch_tpn import assert_run_held_to_float64

CLASSES, SEGS = 5, 4


def recognizer(backbone, channels, head="TSNHead", **head_kw):
    return dict(type="Recognizer2D", backbone=backbone,
                cls_head=dict(type=head, num_classes=CLASSES, in_channels=channels,
                              dropout_ratio=0.0, **head_kw))


R18 = dict(type="ResNet", depth=18, stage_blocks=(1, 1, 1, 1), base_channels=16)
MODELS = {
    "trn_multiscale": (recognizer(R18, 128, "TRNHead", num_segments=SEGS, hidden_dim=16),
                       32),
    "trn_full": (recognizer(R18, 128, "TRNHead", num_segments=SEGS, hidden_dim=16,
                            relation_type="TRN"), 32),
    "tin": (recognizer(dict(type="ResNetTIN", depth=18, num_segments=SEGS), 512), 64),
    "mobilenet_v2": (recognizer(dict(type="MobileNetV2", widen_factor=0.5), 1280), 32),
    "mobilenet_v2_tsm": (recognizer(dict(type="MobileNetV2TSM", num_frames=SEGS,
                                         widen_factor=0.5), 1280, "TSMHead",
                                    num_segments=SEGS), 32),
    "tanet": (recognizer(dict(type="TANet", depth=50, num_segments=SEGS), 2048, "TSMHead",
                         num_segments=SEGS), 32),
    "densenet": (recognizer(dict(type="DenseNet", depth=121, stage_blocks=(1, 2, 2, 1)), 92),
                 32),
}


def models(name, seed=0):
    cfg, res = MODELS[name]
    shape = (2, SEGS, 3, res, res)
    jmodel = build_jax_model(cfg)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    variables = _draw(tree, seed)
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    x = np.random.default_rng(seed + 1).standard_normal(shape).astype(np.float32)
    return jmodel, variables, model, x


@pytest.mark.parametrize("name", list(MODELS))
def test_eval_matches_jax(name):
    """The eval logits and the per-segment features (``extract_feat``)."""
    jmodel, variables, model, x = models(name)
    model.eval()
    xj, xt = jnp.asarray(x), torch.tensor(x)
    with torch.no_grad():
        assert _rel(model(xt), jax.jit(jmodel.apply)(variables, xj)) < 1e-5
        feats = model.extract_feat(xt)
    assert _rel(feats, jmodel.apply(variables, xj, method=jmodel.extract_feat)) < 1e-5


@pytest.mark.parametrize("name", ["tanet", "mobilenet_v2_tsm", "densenet", "tin"])
def test_train_mode_forward_matches_jax(name):
    """A train-mode forward: the logits (batch statistics; TAM's ``g_bn``
    over the last axis of (B, C, T·alpha), whose statistics are per
    T·alpha position) and every running statistic it leaves. A BatchNorm
    over the 8 positions a channel of the last stage magnifies fp32
    rounding, so both packages are held to the port's float64 forward of
    the same weights: JAX's logits within 2e-3 [6.3e-4] and statistics
    within 2e-4 [4.2e-5]; the port's no farther than 1.5x JAX's gap, or
    1e-5 and 1e-6 [TANet: 1.3e-4 and 1.4e-5]."""
    jmodel, variables, model, x = models(name, seed=3)
    want, mut = jax.jit(lambda v, x: jmodel.apply(v, x, deterministic=False,
                                                  mutable=["batch_stats"]))(
        variables, jnp.asarray(x))
    model.train()
    with torch.no_grad():
        got = model(torch.tensor(x))
    cfg = MODELS[name][0]
    m64 = build_model(dict(cfg, backbone=dict(cfg["backbone"], compute_dtype="float64")))
    m64.load_state_dict(params_from_jax(variables))
    m64.double().train()
    with torch.no_grad():
        ref = m64(torch.tensor(x, dtype=torch.float64)).numpy()
    jax_gap, gap = _rel(torch.tensor(np.asarray(want)).double(), ref), _rel(got.double(), ref)
    assert jax_gap < 2e-3 and gap <= max(1.5 * jax_gap, 1e-5)
    stats = params_from_jax({"params": {}, **mut})
    sd, sd64 = model.state_dict(), m64.state_dict()
    assert set(stats) == {k for k in sd if "running" in k}
    jax_stats = max(_sum_rel(v, sd64[k]) for k, v in stats.items())
    assert jax_stats < 2e-4
    assert max(_sum_rel(sd[k], sd64[k]) for k in stats) <= max(1.5 * jax_stats, 1e-6)
    if name == "tanet":
        g_bn = model.backbone.layer1[0].tam.g_bn
        assert g_bn.running_mean.shape == (2 * SEGS,)


def test_tin_trajectory_matches_jax():
    """4 micro-batches of ResNetTIN-18 under SGD (momentum, weight decay, a
    binding global-norm clip) in JAX at float64, in the port at float64
    and at fp32 (``test_torch_tpn.assert_run_held_to_float64``): the
    losses, and the update of every tensor (the offset and gate nets'
    among them, which move) and running statistic [readings: JAX's float64
    run against the port's, losses 0 and updates 1.7e-3 of their size;
    the port's fp32 run against its float64 one, 3.6e-7 and 3.4e-3]."""
    cfg, res = MODELS["tin"]
    variables, model = assert_run_held_to_float64(cfg, (SEGS, 3, res, res))
    start = params_from_jax(variables)
    sd = model.state_dict()
    for k in ("backbone.layer1.0.tin.offset_fc2.weight",
              "backbone.layer4.1.tin.weight_conv.weight"):
        assert not torch.equal(sd[k], start[k]), k


def test_tin_offset_gradient_matches_finite_difference():
    """The interlace's gradient reaches the offsets only through the
    interpolation weight (the gather's indices carry none): d loss /
    d offset_fc2.bias by autograd against a central difference, in
    float64, at offsets away from an integer frame."""
    torch.manual_seed(0)
    tin = TemporalInterlace(16, 6, shift_div=2, compute_dtype=torch.float64).double()
    with torch.no_grad():
        for p in tin.parameters():
            p.copy_(0.3 * torch.randn(p.shape, dtype=torch.float64))
    x = torch.randn(12, 16, 3, 3, dtype=torch.float64)
    g = torch.randn(12, 16, 3, 3, dtype=torch.float64)

    def loss():
        return (tin(x) * g).sum()

    loss().backward()
    grad = tin.offset_fc2.bias.grad.clone()
    eps, fd = 1e-6, torch.zeros_like(grad)
    with torch.no_grad():
        for i in range(grad.numel()):
            tin.offset_fc2.bias[i] += eps
            up = loss()
            tin.offset_fc2.bias[i] -= 2 * eps
            fd[i] = (up - loss()) / (2 * eps)
            tin.offset_fc2.bias[i] += eps
    assert float(grad.abs().min()) > 0
    assert float(((grad - fd).abs() / grad.abs()).max()) < 1e-6


@pytest.mark.parametrize("segments,scale,relations", [(8, 3, 3), (4, 2, 3), (4, 4, 3),
                                                      (8, 7, 5), (3, 2, 9)])
def test_relation_subsets_are_jax(segments, scale, relations):
    assert _relation_subsets(segments, scale, relations) == jax_subsets(
        segments, scale, relations)


def test_trn_head_refuses_another_segment_count():
    model = build_model(MODELS["trn_multiscale"][0]).eval()
    with pytest.raises(ValueError):
        model(torch.zeros(1, SEGS + 1, 3, 32, 32))


def test_mobilenet_tsm_needs_frames_and_tanet_a_bottleneck():
    with pytest.raises(ValueError):
        build_model(recognizer(dict(type="MobileNetV2TSM"), 1280))
    with pytest.raises(ValueError):
        build_model(recognizer(dict(type="TANet", depth=18), 512))
