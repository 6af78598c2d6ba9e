"""The TPN neck of the PyTorch port against the JAX package: the neck alone
(cascade and parallel flows, with and without its aux head, at T = 8 with
scales (2, 4), which makes the flows repeat and pool, and at T = 7 with
scales (4, 8), which -inf pads), TPNHead, TimeSformerHead, the neck in
``Recognizer3D`` (TPN-SlowOnly) and ``Recognizer2D`` (TPN-TSM), and 4-step
SGD trajectories of both with the aux CE term in the loss.

Seeded JAX variables (``test_torch_resnet2d._draw``: the BatchNorms' scales
and statistics drawn away from their constants) convert with
``params_from_jax``. The aux head's dropout (0.5, fixed in the JAX module)
is switched off in both packages for the train-mode comparisons: flax's
``Dropout`` is patched to the identity in this test, the port's module-level
``dropout`` too; nothing of the JAX package is edited.

Tolerances (CPU readings in brackets): eval features, logits and aux
logits 1e-5 of the largest magnitude [fused map 6.9e-7]; train-mode
features 1e-4 [1.5e-6] and running statistics 1e-5 [1.2e-6] per tensor sum
|diff| / sum |ref|. The trajectories run in JAX at float64 (x64 on in that
run alone), in the port at float64 and in the port at fp32, and compare
each tensor's update over the 4 steps (``assert_run_held_to_float64``):
JAX's float64 run against the port's, losses 1e-6 relative [8.9e-8] and
updates 3e-3 of their size [8.4e-4]; the port's fp32 run against its
float64 one, losses 1e-5 [4.9e-7] and updates 1e-2 [1.6e-3].
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.builder import HEADS as JAX_HEADS, NECKS as JAX_NECKS
from adapt_image_models_tpu.models.losses.cross_entropy import NLLLoss as JaxNLLLoss
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.builder import build_head, build_neck
from adapt_image_models_torch.models.losses import NLLLoss
import adapt_image_models_torch.models.necks.tpn as port_tpn

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_recognizer3d_cnn_train import (
    SGD, batches, jax_trajectory, port_trajectory, seeded_variables,
)
from test_torch_resnet2d import _draw, _rel, _sum_rel

# the trajectories' SGD at lr 0.01: at the 3D CNN tests' 0.05 these toys'
# fourth step magnifies fp32 rounding ~1000x in both packages (the port's
# loss 3.5e-4 off its float64 run, JAX's 4.9e-4, their first steps 1e-7),
# so the comparison would read that chaos and not the port
SGD_TOY = dict(SGD, lr=0.01)

CLASSES = 5


class NoDropout(fnn.Module):
    """flax's ``Dropout`` as the identity, for train-mode comparisons."""
    rate: float = 0.0

    @fnn.compact
    def __call__(self, x, deterministic: bool = True):
        return x


@pytest.fixture
def no_dropout(monkeypatch):
    monkeypatch.setattr(fnn, "Dropout", NoDropout)
    monkeypatch.setattr(port_tpn, "dropout", lambda x, rate, generator: x)


def neck_cfg(flow="cascade", aux=True, scales=(2, 4)):
    return dict(type="TPN", in_channels=(64, 128), out_channels=32, flow_type=flow,
                spatial_modulation_cfg=dict(in_channels=(64, 128), out_channels=128),
                temporal_modulation_cfg=dict(downsample_scales=scales),
                upsample_cfg=dict(scale_factor=(1, 1, 1)),
                downsample_cfg=dict(downsample_scale=(1, 1, 1)),
                level_fusion_cfg=dict(in_channels=(32, 32), mid_channels=(32, 32),
                                      out_channels=64,
                                      downsample_scales=((1, 1, 1), (1, 1, 1))),
                aux_head_cfg=dict(out_channels=CLASSES, loss_weight=0.5) if aux else None)


def _wrap(tree, root):
    """A module's variables under the recognizer root ``root``."""
    return {k: {root: v} for k, v in tree.items()}


def _unwrap(sd, prefix):
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def _stage_maps(t, seed, batch=4):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((batch, t, 4, 4, 64)).astype(np.float32),
            rng.standard_normal((batch, t, 2, 2, 128)).astype(np.float32)]


@pytest.mark.parametrize("t,scales", [(8, (2, 4)), (7, (4, 8))])
@pytest.mark.parametrize("aux", [True, False])
@pytest.mark.parametrize("flow", ["cascade", "parallel"])
def test_tpn_neck_matches_jax(flow, aux, t, scales, no_dropout):
    """The neck alone on seeded stage maps: the eval fused map (the port
    skips the aux head in eval mode), then a train-mode forward: fused map,
    aux logits and every BatchNorm's running statistics."""
    cfg = neck_cfg(flow, aux, scales)
    jneck = JAX_NECKS.build(dict(cfg))
    xs = _stage_maps(t, 3)
    xj = [jnp.asarray(x) for x in xs]
    tree = jax.eval_shape(jneck.init, jax.random.PRNGKey(0), xj)
    variables = _draw(tree, 1)
    neck = build_neck(cfg)
    neck.load_state_dict(_unwrap(params_from_jax(_wrap(variables, "neck_module")), "neck."))
    assert neck.aux_weight == (0.5 if aux else 0.0)
    xt = [torch.tensor(x) for x in xs]

    want, want_aux = jax.jit(jneck.apply)(variables, xj)
    assert (want_aux is not None) == aux
    neck.eval()
    with torch.no_grad():
        got, got_aux = neck(xt)
    assert got_aux is None and got.shape == want.shape
    assert _rel(got, want) < 1e-5

    (want, want_aux), mut = jax.jit(lambda v, x: jneck.apply(
        v, x, deterministic=False, mutable=["batch_stats"]))(variables, xj)
    neck.train()
    with torch.no_grad():
        got, got_aux = neck(xt)
    assert _sum_rel(got, want) < 1e-4
    if aux:
        assert _rel(got_aux, want_aux) < 1e-5
    stats = _unwrap(params_from_jax({"params": {}, **_wrap(mut, "neck_module")}), "neck.")
    sd = neck.state_dict()
    assert set(stats) == {k for k in sd if "running" in k}
    for k, v in stats.items():
        assert _sum_rel(sd[k], v) < 1e-5, k


def test_tpn_refuses_what_jax_refuses():
    with pytest.raises(ValueError):
        build_neck(dict(neck_cfg(), flow_type="zigzag"))
    neck = build_neck(neck_cfg())
    with pytest.raises(ValueError):
        neck(_stage_maps(8, 0)[:1])


@pytest.mark.parametrize("spatial_type", ["avg", "max"])
def test_tpn_head_matches_jax(spatial_type):
    cfg = dict(type="TPNHead", num_classes=CLASSES, in_channels=64, spatial_type=spatial_type,
               consensus=dict(type="AvgConsensus", dim=1), dropout_ratio=0.5)
    x = np.random.default_rng(4).standard_normal((3, 2, 2, 2, 64)).astype(np.float32)
    _head_matches_jax(cfg, x)


@pytest.mark.parametrize("shape", [(3, 7, 48), (3, 48)])
def test_timesformer_head_matches_jax(shape):
    """Token 0 of a (B, L, D) input, or (B, D), through fc_cls."""
    x = np.random.default_rng(5).standard_normal(shape).astype(np.float32)
    _head_matches_jax(dict(type="TimeSformerHead", num_classes=CLASSES, in_channels=48), x)


def _head_matches_jax(cfg, x):
    jhead = JAX_HEADS.build(dict(cfg))
    variables = _draw(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), 2)
    head = build_head(cfg).eval()
    head.load_state_dict(_unwrap(params_from_jax(_wrap(variables, "head_module")),
                                 "cls_head."))
    with torch.no_grad():
        got = head(torch.tensor(x))
    want = jhead.apply(variables, jnp.asarray(x))
    assert got.dtype == torch.float32 and _rel(got, want) < 1e-5
    gen = torch.Generator().manual_seed(0)
    head.init_weights(gen)
    w = head.fc_cls.weight.detach()
    assert float(head.fc_cls.bias.detach().abs().max()) == 0.0
    assert abs(float(w.std()) / head.init_std - 1) < 0.3


def test_nll_loss_matches_jax():
    rng = np.random.default_rng(6)
    logp = np.log(rng.dirichlet(np.ones(CLASSES), 4)).astype(np.float32)
    labels = np.array([0, 3, 1, 4])
    want = JaxNLLLoss(loss_weight=0.7)(jnp.asarray(logp), jnp.asarray(labels))
    got = NLLLoss(loss_weight=0.7)(torch.tensor(logp), torch.tensor(labels))
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


# ---- the neck in the recognizers ---------------------------------------------------

def slowonly_cfg(aux=True):
    return dict(type="Recognizer3D",
                backbone=dict(type="ResNet3dSlowOnly", depth=18, base_channels=16,
                              stage_blocks=(1, 1, 1, 1), out_indices=(2, 3)),
                neck=neck_cfg(aux=aux),
                cls_head=dict(type="TPNHead", num_classes=CLASSES, in_channels=64,
                              spatial_type="avg", consensus=dict(type="AvgConsensus", dim=1),
                              dropout_ratio=0.0))


def tsm_cfg():
    return dict(type="Recognizer2D",
                backbone=dict(type="ResNetTSM", depth=18, num_frames=8, base_channels=16,
                              stage_blocks=(1, 1, 1, 1), out_indices=(2, 3)),
                neck=neck_cfg(),
                cls_head=dict(type="TPNHead", num_classes=CLASSES, in_channels=64,
                              dropout_ratio=0.0))


RECOGNIZERS = {"slowonly": (slowonly_cfg(), (3, 8, 64, 64)),
               "tsm": (tsm_cfg(), (8, 3, 64, 64))}


@pytest.mark.parametrize("name", list(RECOGNIZERS))
def test_recognizer_with_neck_matches_jax(name):
    """The eval logits, forward_test's scores (views folded for 3D) and
    ``extract_feat`` (3D: the neck's fused map; 2D: the neck bypassed, as
    in JAX) against JAX."""
    cfg, clip = RECOGNIZERS[name]
    jmodel = build_jax_model(cfg, test_cfg=dict(average_clips="prob"))
    shape = (2,) + clip
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    variables = _draw(tree, 7)
    model = build_model(cfg, test_cfg=dict(average_clips="prob"))
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    x = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    with torch.no_grad():
        assert _rel(model(xt), jax.jit(jmodel.apply)(variables, xj)) < 1e-5
        feats = model.extract_feat(xt)
        assert model.aux_logits is None
    want = jmodel.apply(variables, xj, method=jmodel.extract_feat)
    assert _rel(feats, want) < 1e-5
    if name == "slowonly":  # two views of each clip
        views = np.stack([x, x[::-1]], 1)
        with torch.no_grad():
            got = model.forward_test(torch.tensor(views))
        want = jmodel.apply(variables, jnp.asarray(views), method=jmodel.forward_test)
        assert float((got - torch.tensor(np.asarray(want))).abs().max()) < 1e-6


def float64_trajectory(cfg, variables, data):
    """The port's steps in float64 (weights, compute, optimizer): the
    arbiter of the fp32 trajectories."""
    cfg = dict(cfg, backbone=dict(cfg["backbone"], compute_dtype="float64"))
    if cfg.get("neck"):
        cfg["neck"] = dict(cfg["neck"], compute_dtype="float64")
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.double()
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    optimizer = build_optimizer(SGD_TOY, model, SGD_TOY["lr"], 0.5)
    step, state = make_train_step(model, optimizer), TrainState(model, optimizer)
    losses = [float(step(state, {"imgs": torch.tensor(x, dtype=torch.float64),
                                 "label": torch.tensor(y)}, 0)["loss"]) for x, y in data]
    return np.array(losses), model.state_dict()


def jax_float64_trajectory(cfg, variables, data):
    """JAX's steps with x64 on (in this call alone): weights, inputs and
    ``compute_dtype`` in float64; the heads' and the aux head's ``Dense``
    stay fp32, as the port's do. XLA's optimisations are on for this run:
    without them its float64 convolutions take ~10x longer on the CPU."""
    jcfg = dict(cfg, backbone=dict(cfg["backbone"], compute_dtype=jnp.float64))
    if cfg.get("neck"):
        jcfg["neck"] = dict(cfg["neck"], compute_dtype=jnp.float64)
    data64 = [(x.astype(np.float64), y) for x, y in data]
    unoptimised = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", False)
    try:
        with jax.enable_x64(True):
            v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
            losses, _, sd = jax_trajectory(jcfg, v64, data64, SGD_TOY)
    finally:
        jax.config.update("jax_disable_most_optimizations", unoptimised)
    return np.array(losses), sd


def _update_gap(got, ref, start):
    """sum |(got - start) - (ref - start)| / sum |ref - start|: the gap
    measured against how far the step moved the tensor."""
    moved = (ref.double() - start.double()).abs().sum()
    return float((got.double() - ref.double()).abs().sum() / moved)


def assert_run_held_to_float64(cfg, clip):
    """4 micro-batches of SGD (lr 0.01, momentum, weight decay, a binding
    global-norm clip) in JAX at float64 (``jax_float64_trajectory``), in
    the port at float64 (``float64_trajectory``) and in the port at fp32.
    Each tensor and running statistic is compared by its update, its
    change over the 4 steps: sum |update - ref update| / sum |ref update|,
    so a tensor that did not move is off by 1. The port's float64 run is
    JAX's: losses within 1e-6 relative and every update within 3e-3
    [readings (TPN-SlowOnly, TPN-TSM, TIN): losses 8.9e-8, 0, 0; updates
    8.2e-4, 8.4e-4, 1.7e-3, at the BatchNorm affines and TIN's offset
    biases, whose 4-step updates are 1e-5 to 1e-4 of the tensor; the fp32
    heads are the only part of both runs not in float64]. The port's fp32 run is held to it: losses within 1e-5
    [3.6e-7, 4.9e-7, 3.6e-7] and updates within 1e-2 [1.3e-3, 1.6e-3,
    3.4e-3, the rounding of an fp32 tensor against an update of 1e-5 of
    it]."""
    variables, data = seeded_variables(cfg, clip), batches(clip)
    losses, model = port_trajectory(cfg, variables, data, opt=SGD_TOY)
    ref_losses, ref = float64_trajectory(cfg, variables, data)
    jax_losses, jax64 = jax_float64_trajectory(cfg, variables, data)
    start, got = params_from_jax(variables), model.state_dict()
    assert set(got) == set(ref) == set(jax64)
    moved = [k for k in ref if not torch.equal(ref[k], start[k].double())]
    assert len(moved) == len(ref)
    assert np.abs(jax_losses / ref_losses - 1).max() < 1e-6
    assert np.abs(np.array(losses) / ref_losses - 1).max() < 1e-5
    for k in moved:
        assert _update_gap(jax64[k], ref[k], start[k]) < 3e-3, k
        assert _update_gap(got[k], ref[k], start[k]) < 1e-2, k
    return variables, model


@pytest.mark.parametrize("name", list(RECOGNIZERS))
def test_sgd_trajectory_with_aux_term_matches_jax(name, no_dropout):
    """4 SGD steps whose loss is the head's CE plus 0.5 x the aux head's,
    both packages held to the port's float64 run
    (``assert_run_held_to_float64``); the aux head's tensors move."""
    cfg, clip = RECOGNIZERS[name]
    variables, model = assert_run_held_to_float64(cfg, clip)
    start, sd = params_from_jax(variables), model.state_dict()
    assert not torch.equal(sd["neck.aux_fc.weight"], start["neck.aux_fc.weight"])
    assert not torch.equal(sd["neck.aux_bn.running_mean"], start["neck.aux_bn.running_mean"])


def test_aux_term_joins_the_logged_loss(no_dropout):
    """The step's loss is CE + aux_weight x aux CE, and it logs the aux
    term; without an aux head neither is there; blended (soft) targets
    score the aux logits with soft CE."""
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.models.losses import cross_entropy, soft_cross_entropy
    clip = RECOGNIZERS["slowonly"][1]
    x = torch.tensor(np.random.default_rng(9).standard_normal((2,) + clip), dtype=torch.float32)
    labels = torch.tensor([1, 3])
    for aux in (True, False):
        model = build_model(slowonly_cfg(aux))
        model.init_weights(torch.Generator().manual_seed(0))
        ref = build_model(slowonly_cfg(aux))
        ref.load_state_dict(model.state_dict())
        ref.train()
        logits = ref(x)
        want = cross_entropy(logits, labels)
        if aux:
            want = want + 0.5 * cross_entropy(ref.aux_logits, labels)
        opt = build_optimizer(dict(type="SGD", lr=0.0), model, 0.0)
        metrics = make_train_step(model, opt)(TrainState(model, opt),
                                              {"imgs": x, "label": labels}, 0)
        assert ("aux_loss" in metrics) == aux
        assert abs(float(metrics["loss"]) - float(want.detach())) < 1e-5 * float(want.detach())
    soft = torch.softmax(torch.randn(2, CLASSES, generator=torch.Generator().manual_seed(1)), -1)
    model = build_model(slowonly_cfg())
    model.init_weights(torch.Generator().manual_seed(0))
    ref = build_model(slowonly_cfg())
    ref.load_state_dict(model.state_dict())
    ref.train()
    logits = ref(x)
    want = soft_cross_entropy(logits, soft) + 0.5 * soft_cross_entropy(ref.aux_logits, soft)
    opt = build_optimizer(dict(type="SGD", lr=0.0), model, 0.0)
    metrics = make_train_step(model, opt, blending=lambda i, lab, g: (i, soft))(
        TrainState(model, opt), {"imgs": x, "label": labels}, 0)
    assert abs(float(metrics["loss"]) - float(want.detach())) < 1e-5 * float(want.detach())
