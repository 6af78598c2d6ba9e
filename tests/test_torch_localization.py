"""Temporal action localization in the PyTorch port against the JAX
package: BMN, BSN's TEM and PEM, SSN with its head and losses, their
numpy pieces (labels, soft-NMS, PGM proposals, BSP features, temporal NMS,
AR@AN, AP at tIoU) and the ActivityNet and SSN datasets; and every
localization and skeleton config's model built with the JAX model's tensor
names and shapes.

Seeded JAX variables (``test_torch_resnet2d._draw``) convert with
``params_from_jax``. Toy geometry: BMN at T = 16 with 4 samples of 3 a bin
over 24 features, TEM at T = 16, PEM over 32 BSP features, SSN over a
ResNet-18 of 8 base channels on 16² frames, 2 videos of 8 proposals x 9
segments.

Tolerances (CPU readings in brackets): eval outputs within 2e-5 of their
largest magnitude [BMN 1.2e-7, TEM 1.2e-7, PEM 0, SSN 5.5e-7, its dense
snippet scores 5.0e-7]; the losses within 1e-5 relative [BMN 5.0e-7, TEM
8.6e-8, PEM 0, SSN 0]; the update of one SGD step (-lr times the
gradient), per tensor sum|diff| / sum|ref| within 3e-3, the bound of
``test_torch_tpn.py`` [BMN 3.3e-6, TEM 6.5e-6, PEM 4.4e-7, SSN with its
BatchNorms in eval mode 7.6e-7]. SSN in train mode (batch statistics):
JAX's fp32 gradients do not drift there, so the port is held to them
directly [losses 3.9e-7, updates 4.4e-6], and both to the port's float64
evaluation [JAX 3.9e-7 and 1.9e-6, the port 0 and 3.6e-6], with the same
bounds. The numpy pieces and datasets are exact.
"""

import glob
import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.config.config import Config as JaxConfig
import adapt_image_models_tpu.core.metrics as jax_metrics
import adapt_image_models_tpu.core.proposals as jax_proposals
import adapt_image_models_tpu.core.ssn_utils as jax_ssn_utils
from adapt_image_models_tpu.data.activitynet import ActivityNetDataset as JaxActivityNet
from adapt_image_models_tpu.data.ssn_dataset import SSNDataset as JaxSSNDataset
from adapt_image_models_tpu.models import build_model as build_jax_model
import adapt_image_models_tpu.models.heads.ssn_head as jax_ssn_head
import adapt_image_models_tpu.models.localizers.bmn as jax_bmn
import adapt_image_models_tpu.models.localizers.bsn as jax_bsn
import adapt_image_models_tpu.models.localizers.ssn as jax_ssn
import adapt_image_models_tpu.models.losses.bmn_loss as jax_bmn_loss
import adapt_image_models_tpu.models.losses.ssn_loss as jax_ssn_loss
from adapt_image_models_torch.apis import load_config
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core import metrics, proposals, ssn_utils
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.data.activitynet import ActivityNetDataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.ssn_dataset import SSNDataset
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.heads import ssn_head
from adapt_image_models_torch.models.localizers import bmn, bsn, ssn
from adapt_image_models_torch.models.losses import bmn_loss, ssn_loss

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _draw, _rel, _sum_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EVAL_REL, LOSS_RTOL, UPDATE_REL = 2e-5, 1e-5, 3e-3
LR = 0.1


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _exact(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _exact(got[k], want[k])
    elif isinstance(want, (list, tuple)) and not all(np.isscalar(w) for w in want):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _exact(g, w)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# ---- the models ------------------------------------------------------------------------

BMN_TOY = dict(type="BMN", temporal_dim=16, num_samples=4, num_samples_per_bin=3, feat_dim=24,
               hidden_dim_1d=16, hidden_dim_2d=8, hidden_dim_3d=16)
TEM_TOY = dict(type="TEM", temporal_dim=16, tem_feat_dim=24, tem_hidden_dim=32)
PEM_TOY = dict(type="PEM", pem_feat_dim=32, pem_hidden_dim=16)


def pair(cfg, *inputs, seed=0, **build):
    """The JAX model of ``cfg`` with seeded variables on ``inputs``, and
    the port's model (CPU, eval mode) holding them."""
    jmodel = build_jax_model(dict(cfg), **build)
    variables = _draw(jmodel.init(jax.random.PRNGKey(0), *[jnp.asarray(x) for x in inputs]),
                      seed)
    model = build_model(dict(cfg), device="cpu", **build)
    model.load_state_dict(params_from_jax(variables), strict=True)
    return jmodel, variables, model.eval()


def sgd_update(model, loss):
    """The update of one SGD step of lr LR (no momentum, no decay), -LR
    times the gradient, per parameter name (before it is rounded into the
    weights: the updates of a PEM's biases lie below the weights' ulp)."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {n: -LR * g for (n, _), g in zip(named, grads)}


def jax_update(loss_fn, params):
    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), jax.tree_util.tree_map(lambda g: -LR * np.asarray(g), grads)


def assert_updates_close(port, jax_params_update, bound, floor=1e-12):
    want = params_from_jax(jax_params_update)
    assert set(want) == set(port)
    for n, w in want.items():
        assert _sum_rel(port[n], w) <= bound or float(w.abs().sum()) < floor, n


def bmn_batch(seed, b=2, t=16, c=24):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, c, t)).astype(np.float32)
    gts = [[(0.1, 0.4), (0.55, 0.9)], [(0.3, 0.62)]][:b]
    labels = [jax_bmn.generate_bmn_labels(g, t) for g in gts]
    return x, {k: np.stack([lab[k] for lab in labels]) for k in labels[0]}


def test_bmn_matches_jax():
    """Eval outputs, BMNLoss's four terms and one SGD step's update."""
    x, labels = bmn_batch(0)
    jmodel, variables, model = pair(BMN_TOY, x)
    want = jmodel.apply(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    for k in ("confidence_map", "start", "end"):
        assert _rel(got[k], want[k]) < EVAL_REL, k
    mask = jax_bmn._bm_valid_mask(16)
    np.testing.assert_array_equal(bmn.bm_valid_mask(16), mask)
    jlosses = jax_bmn_loss.BMNLoss()(want, {k: jnp.asarray(v) for k, v in labels.items()},
                                     jnp.asarray(mask))
    losses = bmn_loss.BMNLoss()(got, {k: torch.from_numpy(v) for k, v in labels.items()},
                                torch.from_numpy(mask))
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x))
        return jax_bmn_loss.BMNLoss()(out, {k: jnp.asarray(v) for k, v in labels.items()},
                                      jnp.asarray(mask))["loss"]

    jloss, jup = jax_update(jax_loss, variables["params"])
    model.train()
    loss = bmn_loss.BMNLoss()(model(torch.from_numpy(x)),
                              {k: torch.from_numpy(v) for k, v in labels.items()},
                              torch.from_numpy(mask))["loss"]
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_updates_close(sgd_update(model, loss), jup, UPDATE_REL)


def test_bmn_numpy_pieces_match_jax():
    """The sampling mask, the labels, soft-NMS and the proposals of one
    video's outputs: exact."""
    np.testing.assert_array_equal(bmn._interp1d_mask(16, 4, 3, 0.5),
                                  jax_bmn._interp1d_mask(16, 4, 3, 0.5))
    np.testing.assert_array_equal(bmn._interp1d_mask(20, 8, 2, 0.3),
                                  jax_bmn._interp1d_mask(20, 8, 2, 0.3))
    for gts in ([(0.1, 0.4), (0.55, 0.9)], [], [(0.0, 1.0)]):
        _exact(bmn.generate_bmn_labels(gts, 16), jax_bmn.generate_bmn_labels(gts, 16))
    rng = np.random.default_rng(1)
    props = np.sort(rng.random((60, 2)), axis=1)
    props = np.concatenate([props, rng.random((60, 1))], axis=1).astype(np.float32)
    props = props[np.argsort(-props[:, 2])]
    for args in ((0.4, 0.5, 0.9, 100), (0.75, 0.65, 0.9, 10)):
        _exact(bmn.soft_nms(props, *args), jax_bmn.soft_nms(props, *args))
    x, _ = bmn_batch(2)
    jmodel, variables, model = pair(BMN_TOY, x)
    with torch.no_grad():
        out = {k: v[0].numpy() for k, v in model(torch.from_numpy(x)).items()}
    _exact(model.proposals_from_outputs(out), jmodel.proposals_from_outputs(out))


def test_tem_matches_jax():
    """Eval scores, the three losses and one SGD step's update; the labels
    and the anchors."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    jmodel, variables, model = pair(TEM_TOY, x)
    want = jmodel.apply(variables, jnp.asarray(x))
    got = model(torch.from_numpy(x))
    assert _rel(got, want) < EVAL_REL
    _exact(model.anchors(), jmodel.anchors())
    gts = ([(0.1, 0.4), (0.55, 0.9)], [(0.3, 0.62)])
    labels = [bsn.generate_tem_labels(g, 16, 0.1) for g in gts]
    for g, lab in zip(gts, labels):
        _exact(lab, jax_bsn.generate_tem_labels(np.asarray(g), 16, 0.1))
    _exact(bsn.generate_tem_labels(np.zeros((0, 2)), 16, 0.1),
           jax_bsn.generate_tem_labels(np.zeros((0, 2)), 16, 0.1))
    stacked = {k: np.stack([lab[k] for lab in labels]) for k in labels[0]}
    jlosses = jmodel.loss(want, {k: jnp.asarray(v) for k, v in stacked.items()})
    losses = model.loss(got, {k: torch.from_numpy(v) for k, v in stacked.items()})
    for k, v in jlosses.items():
        assert abs(float(losses[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x))
        return sum(jmodel.loss(out, {k: jnp.asarray(v) for k, v in stacked.items()}).values())

    jloss, jup = jax_update(jax_loss, variables["params"])
    model.train()
    loss = sum(model.loss(model(torch.from_numpy(x)),
                          {k: torch.from_numpy(v) for k, v in stacked.items()}).values())
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_updates_close(sgd_update(model, loss), jup, UPDATE_REL)


@pytest.mark.parametrize("ratios", [(1.0, 2.0), (0.2, 0.3)])
def test_pem_matches_jax(ratios):
    """Eval scores; the loss on JAX's own uniform draws (the two bands'
    subsampling, at full and partial keep ratios) and one SGD step's
    update; the soft-NMS'd proposals of the scores."""
    rng = np.random.default_rng(4)
    feat = rng.random((200, 32)).astype(np.float32)
    ref_iou = rng.random(200).astype(np.float32)
    cfg = dict(PEM_TOY, pem_u_ratio_m=ratios[0], pem_u_ratio_l=ratios[1])
    jmodel, variables, model = pair(cfg, feat)
    want = jmodel.apply(variables, jnp.asarray(feat))
    got = model(torch.from_numpy(feat))
    assert _rel(got, want) < EVAL_REL
    key = jax.random.PRNGKey(9)
    k_m, k_l = jax.random.split(key)
    draws = torch.tensor(np.stack([np.asarray(jax.random.uniform(k_m, (200,))),
                                   np.asarray(jax.random.uniform(k_l, (200,)))]))

    def jax_loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(feat))
        return jmodel.loss(out, jnp.asarray(ref_iou), key)["temporal_iou_loss"]

    jloss, jup = jax_update(jax_loss, variables["params"])
    model.train()
    loss = model.loss(model(torch.from_numpy(feat)), torch.from_numpy(ref_iou),
                      draws=draws)["temporal_iou_loss"]
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_updates_close(sgd_update(model, loss), jup, UPDATE_REL)
    # the generator path draws the same shapes and keeps the high band whole
    gen_loss = model.loss(got, torch.from_numpy(ref_iou),
                          generator=torch.Generator().manual_seed(0))["temporal_iou_loss"]
    assert torch.isfinite(gen_loss)
    props = np.asarray(jax_proposals.generate_candidate_proposals(
        rng.random(16).astype(np.float32), rng.random(16).astype(np.float32), 0.5,
        [(0.2, 0.6)]))[:20]
    scores = rng.random(len(props)).astype(np.float32)
    info = dict(duration_second=90.0, duration_frame=2700, feature_frame=2688)
    _exact(model.proposals_from_outputs(scores, props, info),
           jmodel.proposals_from_outputs(scores, props, info))


SSN_K = 4
SSN_TRAIN_CFG = dict(ssn=dict(
    sampler=dict(num_per_video=8, positive_ratio=1, background_ratio=1, incomplete_ratio=6),
    loss_weight=dict(comp_loss_weight=0.1, reg_loss_weight=0.1)))
SSN_TOY = dict(type="SSN",
               backbone=dict(type="ResNet", depth=18, stage_blocks=(1, 1, 1, 1), base_channels=8),
               cls_head=dict(type="SSNHead", in_channels=64, num_classes=SSN_K,
                             stpp_cfg=(1, (1, 2), 1), num_segments_list=(2, 5, 2),
                             dropout_ratio=0.0),
               dropout_ratio=0.0, loss_cls=dict(type="SSNLoss"))


def ssn_batch(seed, videos=2):
    rng = np.random.default_rng(seed)
    n = videos * 8
    imgs = rng.normal(size=(n * 9, 3, 16, 16)).astype(np.float32)
    sf = rng.uniform(0.5, 1.5, (n, 2)).astype(np.float32)
    ptype = np.tile([0] + [1] * 6 + [2], videos)
    labels = np.tile(rng.integers(1, SSN_K + 1, 8), videos)
    labels[ptype == 2] = 0
    reg = rng.normal(size=(n, 2)).astype(np.float32)
    return imgs, sf, ptype, labels, reg


@pytest.fixture(scope="module")
def ssn_pair():
    imgs, sf, *_ = ssn_batch(5)
    return pair(SSN_TOY, imgs, sf, seed=6, train_cfg=SSN_TRAIN_CFG)


def test_ssn_eval_matches_jax(ssn_pair):
    """The three outputs (an STPP of two parts in the course stage), the
    dense snippet scores and the losses with the BatchNorms' running
    statistics, and one SGD step's update there."""
    jmodel, variables, model = ssn_pair
    imgs, sf, ptype, labels, reg = ssn_batch(5)
    want = jmodel.apply(variables, jnp.asarray(imgs), jnp.asarray(sf))
    with torch.no_grad():
        got = model(torch.from_numpy(imgs), torch.from_numpy(sf))
    for g, w in zip(got, want):
        assert _rel(g, w) < EVAL_REL
    jdense = jmodel.apply(variables, jnp.asarray(imgs[:30]), method=jmodel.snippet_scores)
    with torch.no_grad():
        dense = model.snippet_scores(torch.from_numpy(imgs[:30]))
    for g, w in zip(dense, jdense):
        assert _rel(g, w) < EVAL_REL
    inputs = [jnp.asarray(a) for a in (imgs, sf, ptype, labels, reg)]

    def jax_loss(params):
        losses = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                              *inputs, method=jmodel.forward_train, deterministic=True)
        return sum(losses.values())

    jloss, jup = jax_update(jax_loss, variables["params"])
    losses = model.forward_train(*[torch.from_numpy(np.asarray(a))
                                   for a in (imgs, sf, ptype, labels, reg)])
    loss = sum(losses.values())
    assert set(losses) == {"loss_activity", "loss_completeness", "loss_reg"}
    assert abs(float(loss) - jloss) <= LOSS_RTOL * abs(jloss)
    assert_updates_close(sgd_update(model, loss), jup, UPDATE_REL)
    model.load_state_dict(params_from_jax(variables))  # the fixture's weights again


def test_ssn_train_mode_matches_jax(ssn_pair):
    """Batch statistics: the port's fp32 loss and one SGD step's update
    against JAX's, and both against the port's float64 evaluation of the
    same weights."""
    jmodel, variables, model = ssn_pair
    imgs, sf, ptype, labels, reg = ssn_batch(7)
    inputs = [jnp.asarray(a) for a in (imgs, sf, ptype, labels, reg)]

    def jax_loss(params):
        losses, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                 *inputs, method=jmodel.forward_train, deterministic=False,
                                 mutable=["batch_stats"])
        return sum(losses.values())

    jloss, jup = jax_update(jax_loss, variables["params"])
    jup = params_from_jax(jup)

    def port(dtype):
        cfg = dict(SSN_TOY, backbone=dict(SSN_TOY["backbone"], compute_dtype=dtype),
                   cls_head=dict(SSN_TOY["cls_head"], compute_dtype=dtype))
        m = build_model(cfg, device="cpu", train_cfg=SSN_TRAIN_CFG).to(dtype)
        m.load_state_dict(params_from_jax(variables))
        m.train()
        args = [torch.from_numpy(np.asarray(a)) for a in (imgs, sf, ptype, labels, reg)]
        args = [a.to(dtype) if a.is_floating_point() else a for a in args]
        loss = sum(m.forward_train(*args).values())
        return float(loss), sgd_update(m, loss)

    ref_loss, ref_up = port(torch.float64)
    loss32, up32 = port(torch.float32)
    assert abs(loss32 - jloss) <= LOSS_RTOL * abs(jloss)
    assert abs(jloss - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    assert abs(loss32 - ref_loss) <= LOSS_RTOL * abs(ref_loss)
    for n, ref in ref_up.items():
        if float(ref.abs().sum()) < 1e-12:
            continue
        assert _sum_rel(up32[n], jup[n]) <= UPDATE_REL, n
        assert _sum_rel(jup[n].double(), ref) <= UPDATE_REL, n
        assert _sum_rel(up32[n].double(), ref) <= UPDATE_REL, n


def test_losses_match_jax():
    """binary_logistic_loss, tem_loss, pem_reg_loss, pem_cls_loss, the
    registry's BinaryLogisticRegressionLoss, ohem_hinge_loss (value and
    gradient: the selected examples alone) and SSNLoss's terms."""
    rng = np.random.default_rng(8)
    pred = rng.random((3, 16, 16)).astype(np.float32)
    gt = rng.random((3, 16, 16)).astype(np.float32)
    mask = bmn.bm_valid_mask(16)
    for f, args in (("binary_logistic_loss", (pred, gt)), ("binary_logistic_loss", (pred, gt, 0.9)),
                    ("pem_reg_loss", (pred, gt, mask)), ("pem_cls_loss", (pred, gt, mask)),
                    ("tem_loss", (pred[0], pred[1], gt[0], gt[1]))):
        got = getattr(bmn_loss, f)(*[torch.from_numpy(np.asarray(a)) for a in args])
        want = getattr(jax_bmn_loss, f)(*[jnp.asarray(a) for a in args])
        assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want)), f
    got = bmn_loss.BinaryLogisticRegressionLoss()(torch.from_numpy(pred), torch.from_numpy(gt))
    assert abs(float(got) - float(jax_bmn_loss.binary_logistic_loss(pred, gt))) < 1e-6

    scores = rng.normal(size=(12, 5)).astype(np.float32)
    labels = rng.integers(1, 6, 12)
    t = torch.tensor(scores, requires_grad=True)
    got = ssn_loss.ohem_hinge_loss(t, torch.from_numpy(labels), -1, 0.5, 6)
    got.backward()
    want, jgrad = jax.value_and_grad(
        lambda p: jax_ssn_loss.ohem_hinge_loss(p, jnp.asarray(labels), -1, 0.5, 6))(
        jnp.asarray(scores))
    assert abs(float(got) - float(want)) <= LOSS_RTOL * abs(float(want))
    np.testing.assert_array_equal(t.grad.numpy(), np.asarray(jgrad))
    assert ssn_loss.sampler_layout(SSN_TRAIN_CFG["ssn"]["sampler"]) == (1, 6, 1)

    _, sf, ptype, labels, reg = ssn_batch(9)
    act = rng.normal(size=(16, SSN_K + 1)).astype(np.float32)
    comp = rng.normal(size=(16, SSN_K)).astype(np.float32)
    box = rng.normal(size=(16, SSN_K, 2)).astype(np.float32)
    args = (act, comp, box, ptype, labels, reg)
    got = ssn_loss.SSNLoss()(*[torch.from_numpy(np.asarray(a)) for a in args], SSN_TRAIN_CFG)
    want = jax_ssn_loss.SSNLoss()(*[jnp.asarray(a) for a in args], SSN_TRAIN_CFG)
    for k, v in want.items():
        assert abs(float(got[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), k


def test_ssn_head_pieces_match_jax():
    """parse_stage_config, stpp_train_pool (a two-part stage) and
    stpp_test_pool, ssn_test_post with the regression denormalised."""
    assert ssn_head.parse_stage_config((1, 2)) == jax_ssn_head.parse_stage_config((1, 2))
    with pytest.raises(ValueError):
        ssn_head.parse_stage_config("x")
    rng = np.random.default_rng(10)
    x = rng.normal(size=(3 * 9, 6)).astype(np.float32)
    sf = rng.uniform(0.5, 1.5, (3, 2)).astype(np.float32)
    for stpp in ((1, 1, 1), (1, (1, 2), 1)):
        got = ssn_head.stpp_train_pool(torch.from_numpy(x), torch.from_numpy(sf), stpp,
                                       (2, 5, 2))
        want = jax_ssn_head.stpp_train_pool(jnp.asarray(x), jnp.asarray(sf), stpp, (2, 5, 2))
        for g, w in zip(got, want):
            assert _rel(g, w) < 1e-6
    act = rng.normal(size=(30, 5)).astype(np.float32)
    comp = rng.normal(size=(30, 5, 4)).astype(np.float32)  # 5 STPP parts
    reg = rng.normal(size=(30, 5, 8)).astype(np.float32)
    ticks = np.array([[0, 3, 10, 14], [5, 8, 20, 29], [25, 28, 29, 30], [0, 0, 1, 2]])
    sfs = rng.uniform(0.5, 1.5, (4, 2)).astype(np.float32)
    consts = np.array([[0.1, -0.2], [0.5, 0.7]], np.float32)
    stpp = (1, (1, 2), 1)
    _exact(ssn_head.stpp_test_pool(act, comp, reg, ticks, sfs, stpp),
           jax_ssn_head.stpp_test_pool(act, comp, reg, ticks, sfs, stpp))
    _exact(ssn.ssn_test_post(act, comp, reg, ticks, sfs, consts, stpp),
           jax_ssn.ssn_test_post(act, comp, reg, ticks, sfs, consts, stpp))
    _exact(ssn.ssn_test_post(act, comp, None, ticks, sfs, None, stpp),
           jax_ssn.ssn_test_post(act, comp, None, ticks, sfs, None, stpp))


# ---- proposals, metrics and the SSN utilities ------------------------------------------------

def test_proposal_utilities_match_jax():
    """temporal_iou / temporal_iop, PGM candidate proposals (with and
    without gts), BSP features and the PEM post-processing: exact."""
    rng = np.random.default_rng(11)
    a, b = np.sort(rng.random((2, 40, 2)), axis=-1)
    for f in ("temporal_iou", "temporal_iop"):
        _exact(getattr(proposals, f)(a[:, 0], a[:, 1], b[:, 0], b[:, 1]),
               getattr(jax_proposals, f)(a[:, 0], a[:, 1], b[:, 0], b[:, 1]))
    start, end, action = rng.random((3, 50)).astype(np.float32)
    for gt in (None, [(0.1, 0.3), (0.5, 0.95)]):
        got = proposals.generate_candidate_proposals(start, end, 0.5, gt)
        _exact(got, jax_proposals.generate_candidate_proposals(start, end, 0.5, gt))
    _exact(proposals.generate_bsp_feature(got, action, top_k=100),
           jax_proposals.generate_bsp_feature(got, action, top_k=100))
    _exact(proposals.generate_bsp_feature(got, action, 0.3, 4, 4, 8, 2, 30),
           jax_proposals.generate_bsp_feature(got, action, 0.3, 4, 4, 8, 2, 30))
    result = np.concatenate([got[:30, :4], rng.random((30, 2)).astype(np.float32)], axis=1)
    for info in (dict(duration_second=80.0), dict(duration_second=80.0, duration_frame=2400,
                                                  feature_frame=2384)):
        _exact(proposals.post_processing(result, info, 0.75, 0.65, 0.9, 20),
               jax_proposals.post_processing(result, info, 0.75, 0.65, 0.9, 20))


def test_metrics_match_jax():
    """pairwise_temporal_iou (with the overlap over each candidate) and
    AR@AN with the AUC, over videos with fewer and more proposals than the
    average: exact."""
    rng = np.random.default_rng(12)
    cand = np.sort(rng.random((30, 2)), axis=1)
    gts = np.sort(rng.random((4, 2)), axis=1)
    _exact(metrics.pairwise_temporal_iou(cand, gts), jax_metrics.pairwise_temporal_iou(cand, gts))
    _exact(metrics.pairwise_temporal_iou(cand, gts, True),
           jax_metrics.pairwise_temporal_iou(cand, gts, True))
    gt = {f"v{i}": np.sort(rng.random((int(rng.integers(1, 4)), 2)), axis=1) for i in range(5)}
    props = {}
    for i, vid in enumerate(gt):
        n = [3, 40, 120, 0, 60][i]
        p = np.sort(rng.random((n, 2)), axis=1)
        props[vid] = np.concatenate([p, rng.random((n, 1))], axis=1)
    total = sum(len(p) for p in props.values())
    for max_avg in (100, 20):
        _exact(metrics.average_recall_at_avg_proposals(gt, props, total, max_avg),
               jax_metrics.average_recall_at_avg_proposals(gt, props, total, max_avg))


PROPOSAL_FILE = """# 0
video_a
{frames}
1
2
2 40 120
1 150 170
5
2 0.95 0.95 42 118
2 0.30 0.80 60 110
1 0.85 0.90 148 171
0 0.00 0.00 130 145
0 0.00 0.00 5 35
# 1
video_b
{frames}
1
1
1 100 180
4
1 0.90 0.90 98 178
1 0.25 0.75 120 170
0 0.00 0.00 10 80
0 0.00 0.00 0 60
"""


@pytest.fixture(scope="module")
def proposal_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("ssn") / "props.txt"
    path.write_text(PROPOSAL_FILE.format(frames=200))
    return str(path)


def test_ssn_utilities_match_jax(proposal_file):
    """The proposal file, regression, temporal NMS, the interpolated AP,
    AP at tIoU and eval_ap: exact."""
    _exact(ssn_utils.load_localize_proposal_file(proposal_file),
           jax_ssn_utils.load_localize_proposal_file(proposal_file))
    rng = np.random.default_rng(13)
    dets = np.concatenate([np.sort(rng.random((40, 2)), axis=1), rng.random((40, 3))], axis=1)
    _exact(ssn_utils.perform_regression(dets), jax_ssn_utils.perform_regression(dets))
    for thr in (0.2, 0.5):
        _exact(ssn_utils.temporal_nms(dets, thr), jax_ssn_utils.temporal_nms(dets, thr))
    prec, rec = np.sort(rng.random((2, 20)), axis=1)
    assert ssn_utils.interpolated_precision_recall(prec[::-1], rec) == \
        jax_ssn_utils.interpolated_precision_recall(prec[::-1], rec)
    gt = {"a": np.array([[0.1, 0.3], [0.5, 0.8]]), "b": np.array([[0.2, 0.9]])}
    pred = [[vid, 0, *np.sort(rng.random(2)), float(rng.random())]
            for vid in ("a", "b", "c") for _ in range(6)]
    thresholds = np.linspace(0.1, 0.9, 9)
    _exact(ssn_utils.average_precision_at_temporal_iou(gt, pred, thresholds),
           jax_ssn_utils.average_precision_at_temporal_iou(gt, pred, thresholds))
    detections = {0: pred, 1: pred[:5]}
    by_cls = {0: gt, 1: {"a": [[0.4, 0.6]]}}
    _exact(ssn_utils.eval_ap(detections, by_cls, thresholds),
           jax_ssn_utils.eval_ap(detections, by_cls, thresholds))


# ---- the datasets ----------------------------------------------------------------------------

def ssn_kwargs(**kw):
    return dict(train_cfg=dict(ssn=dict(
        sampler=dict(num_per_video=8, positive_ratio=1, background_ratio=1,
                     incomplete_ratio=6, add_gt_as_proposals=True),
        assigner=dict(positive_iou_threshold=0.7, incomplete_iou_threshold=0.6,
                      background_iou_threshold=0.05, background_coverage_threshold=0.02,
                      incomplete_overlap_threshold=0.7))),
        body_segments=5, aug_segments=(2, 2), aug_ratio=0.5, **kw)


def _instances(pool):
    return [(vid, p.start_frame, p.end_frame, p.label, p.best_iou, p.overlap_self,
             p.coverage, tuple(p.regression_targets)) for vid, p in pool]


@pytest.mark.parametrize("video_centric", [True, False])
def test_ssn_dataset_matches_jax(proposal_file, video_centric):
    """The pools, the regression normalisation, prepare_train under the
    same generator (both samplings), prepare_test, the detections and the
    mAP of synthetic results: exact."""
    kw = ssn_kwargs(clip_len=2, frame_interval=2, video_centric=video_centric)
    ds, ref = SSNDataset(proposal_file, **kw), JaxSSNDataset(proposal_file, **kw)
    for pool in ("positive_pool", "incomplete_pool", "background_pool"):
        assert _instances(getattr(ds, pool)) == _instances(getattr(ref, pool)), pool
    _exact(ds.reg_norm_consts, ref.reg_norm_consts)
    for idx in range(len(ds)):
        for seed in range(3):
            _exact(ds.prepare_train(idx, np.random.default_rng(seed)),
                   ref.prepare_train(idx, np.random.default_rng(seed)))
    tkw = ssn_kwargs(test_mode=True, test_cfg=dict(ssn=dict(evaluater=dict(top_k=100,
                                                                            nms=0.2))))
    tds, tref = SSNDataset(proposal_file, **tkw), JaxSSNDataset(proposal_file, **tkw)
    rng = np.random.default_rng(14)
    results = []
    for idx in range(len(tds)):
        item = tds.prepare_test(idx)
        _exact(item, tref.prepare_test(idx))
        _exact(tds[idx], tref[idx])
        n = len(item["relative_proposal_list"])
        results.append(dict(relative_proposal_list=item["relative_proposal_list"],
                            activity_scores=rng.normal(size=(n, 3)).astype(np.float32),
                            completeness_scores=rng.normal(size=(n, 2)).astype(np.float32),
                            bbox_preds=0.1 * rng.normal(size=(n, 2, 2)).astype(np.float32)))
    _exact(tds.get_all_gts(), tref.get_all_gts())
    _exact(tds.results_to_detections(results, top_k=50), tref.results_to_detections(results,
                                                                                     top_k=50))
    assert tds.evaluate(results, iou_range=(0.3, 0.5, 0.7)) == \
        tref.evaluate(results, iou_range=(0.3, 0.5, 0.7))


def write_activitynet(root, n, seed, feat_dim=8, rows=(12, 20)):
    """A json of ``n`` videos and each one's features as a .npy and as the
    reference's .csv (a header line, full precision), ``rows[0]`` or
    ``rows[1]`` snippets long."""
    rng = np.random.default_rng(seed)
    anno = {}
    os.makedirs(os.path.join(root, "npy"), exist_ok=True)
    os.makedirs(os.path.join(root, "csv"), exist_ok=True)
    for i in range(n):
        name = f"v_{i:03d}"
        dur = float(rng.uniform(20, 100))
        segs = [sorted(rng.uniform(0, dur, 2).tolist()) for _ in range(int(rng.integers(0, 3)))]
        anno[name] = dict(duration_second=dur,
                          annotations=[dict(segment=s, label="x") for s in segs])
        feat = rng.normal(size=(rows[i % 2], feat_dim)).astype(np.float32)
        np.save(os.path.join(root, "npy", name + ".npy"), feat)
        np.savetxt(os.path.join(root, "csv", name + ".csv"), feat, delimiter=",",
                   header=",".join(f"f{c}" for c in range(feat_dim)), comments="")
    path = os.path.join(root, "anno.json")
    with open(path, "w") as f:
        json.dump(anno, f)
    return path


def test_activitynet_dataset_matches_jax(tmp_path):
    """Features (.npy as JAX, and the reference's .csv giving the same
    values), resized to temporal_dim; the gt segments; AR@AN of random
    proposals; the pipeline's samples through the loader, gt_bbox a list a
    video; LoadProposals' fields."""
    ann = write_activitynet(str(tmp_path), 6, seed=15)
    pipeline = [dict(type="LoadLocalizationFeature"), dict(type="GenerateLocalizationLabels")]
    ds = ActivityNetDataset(ann, pipeline=pipeline, data_prefix=str(tmp_path / "npy"),
                            temporal_dim=16)
    csv = ActivityNetDataset(ann, pipeline=pipeline, data_prefix=str(tmp_path / "csv"),
                             temporal_dim=16)
    ref = JaxActivityNet(ann, data_prefix=str(tmp_path / "npy"), temporal_dim=16)
    assert len(ds) == len(ref) == 6
    rng = np.random.default_rng(16)
    results = {}
    for i in range(len(ds)):
        _exact(ds.load_feature(i), ref.load_feature(i))
        _exact(csv.load_feature(i), ref.load_feature(i))
        _exact(ds.gt_segments(i), ref.gt_segments(i))
        sample = csv.prepare_sample(i)
        _exact(sample["raw_feature"], ref.load_feature(i).T)
        assert sample["gt_bbox"] == ref.gt_segments(i).tolist()
        p = np.sort(rng.random((int(rng.integers(0, 30)), 2)), axis=1)
        results[ds.video_infos[i]["video_name"]] = np.concatenate(
            [p, rng.random((len(p), 1))], axis=1)
    assert ds.evaluate(results) == ref.evaluate(results)
    batch = next(iter(VideoLoader(csv, None, 3, num_workers=1)))
    assert batch["raw_feature"].shape == (3, 8, 16)
    assert batch["gt_bbox"] == [ref.gt_segments(i).tolist() for i in range(3)]
    with pytest.raises(KeyError):
        ds.evaluate(results, metrics=("mAP",))
    with pytest.raises(KeyError, match="unsupported localization pipeline step"):
        ActivityNetDataset(ann, pipeline=[dict(type="Decode")])

    os.makedirs(tmp_path / "pgm_p")
    os.makedirs(tmp_path / "pgm_f")
    name = ds.video_infos[0]["video_name"]
    props = rng.random((9, 7)).astype(np.float32)
    np.savetxt(tmp_path / "pgm_p" / f"{name}.csv", props, delimiter=",",
               header="tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa",
               comments="")
    np.save(tmp_path / "pgm_f" / f"{name}.npy", rng.random((9, 32)).astype(np.float32))
    pem = ActivityNetDataset(ann, pipeline=[dict(type="LoadProposals", top_k=5,
                                                 pgm_proposals_dir=str(tmp_path / "pgm_p"),
                                                 pgm_features_dir=str(tmp_path / "pgm_f"))])
    sample = pem.prepare_sample(0)
    _exact(sample["reference_temporal_iou"], props[:5, 5])
    _exact(sample["tmin"], props[:5, 0])
    assert sample["bsp_feature"].shape == (5, 32)


# ---- every localization and skeleton config ------------------------------------------------

def _configs():
    out = []
    for sub in ("localization", "skeleton"):
        for path in sorted(glob.glob(os.path.join(ROOT, "configs", sub, "**", "*.py"),
                                     recursive=True)):
            model = JaxConfig.fromfile(path).to_dict().get("model")
            if model:
                out.append(os.path.relpath(path, os.path.join(ROOT, "configs")))
    return out


CONFIGS = _configs()


def test_config_count():
    """5 localizers (BMN, TEM, PEM, the two SSN files; bsn_pgm has no
    model) and the 6 posec3d recipes."""
    assert len(CONFIGS) == 11
    assert sum(c.startswith("localization") for c in CONFIGS) == 5


def _init_sample(model):
    if model["type"] in ("BMN", "TEM"):
        dim = model.get("feat_dim", model.get("tem_feat_dim", 400))
        return (jax.ShapeDtypeStruct((1, dim, model.get("temporal_dim", 100)), jnp.float32),)
    if model["type"] == "PEM":
        return (jax.ShapeDtypeStruct((4, model.get("pem_feat_dim", 32)), jnp.float32),)
    if model["type"] == "SSN":
        return (jax.ShapeDtypeStruct((9, 3, 64, 64), jnp.float32),
                jax.ShapeDtypeStruct((1, 2), jnp.float32))
    channels = model["backbone"]["in_channels"]
    return (jax.ShapeDtypeStruct((1, channels, 8, 32, 32), jnp.float32),)


@pytest.mark.parametrize("name", CONFIGS)
def test_config_builds_with_jax_names_and_shapes(name):
    """The port's state dict (built on the meta device from the config)
    has the keys and shapes of the JAX model's init (``jax.eval_shape``),
    BatchNorm statistics included, so the parameter counts are equal."""
    cfg = load_config(os.path.join(ROOT, "configs", name))
    mcfg = {k: v for k, v in cfg["model"].items() if k not in ("train_cfg", "test_cfg")}
    build = dict(train_cfg=cfg["model"].get("train_cfg"), test_cfg=cfg["model"].get("test_cfg"))
    tree = jax.eval_shape(build_jax_model(mcfg, **build).init, jax.random.PRNGKey(0),
                          *_init_sample(mcfg))
    zeros = jax.tree_util.tree_map(lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    want = {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}
    model = build_model(mcfg, device="meta", **build)
    assert {k: tuple(v.shape) for k, v in model.state_dict().items()} == want
    n_jax = sum(int(np.prod(s.shape)) for s in jax.tree_util.tree_leaves(tree["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax


def test_adam_is_torch_adam_with_l2_decay():
    """The localization recipes' Adam: torch's Adam, the weight decay an
    L2 term on the weights and none on the biases (DEFAULT_NO_DECAY_KEYS)."""
    torch.manual_seed(0)
    model = build_model(dict(PEM_TOY), device="cpu")
    ref = build_model(dict(PEM_TOY), device="cpu")
    ref.load_state_dict(model.state_dict())
    opt = build_optimizer(dict(type="Adam", lr=0.01, weight_decay=1e-2), model, 0.01)
    decay = [p for n, p in ref.named_parameters() if not n.endswith("bias")]
    rest = [p for n, p in ref.named_parameters() if n.endswith("bias")]
    torch_opt = torch.optim.Adam([dict(params=decay, weight_decay=1e-2),
                                  dict(params=rest, weight_decay=0.0)], lr=0.01)
    x = torch.randn(6, 32)
    for _ in range(2):
        opt.update(torch.autograd.grad(model(x).sum(), opt.params))
        torch_opt.zero_grad()
        ref(x).sum().backward()
        torch_opt.step()
    for (n, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p, q), n
