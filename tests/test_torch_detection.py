"""AVA detection of the PyTorch port against the JAX package: RoIAlign
(``ops/roi_align.py``) forward and gradient, ``SingleRoIExtractor3D``
(avg, max, ``with_global``), ``BBoxHeadAVA``'s logits and loss,
``FastRCNN`` over SlowOnly and SlowFast (with the ACRN and FBO shared
heads too), four SGD steps of ``train_model`` on a detector config
(``train_detector``) against JAX's ``make_detection_train_step`` on the
same samples, auto-resume, SIGTERM, ``tools/train_torch.py`` on a detector
config, and ``run_detection_evaluation``'s frame mAP on the AVA fixture of
``tests/test_data/test_ava.py``.

Weights: seeded JAX variables (``tests/test_torch_resnet2d.py::_draw``)
loaded through ``params_from_jax``. Toys: SlowOnly-50 at base width 8,
one block a stage, spatial strides (1, 2, 2, 1) as the AVA recipes; the
tests' SlowFast (base 16, alpha 4); 4 (SlowOnly) or 8 (SlowFast) frames of
32² (the fixture's crops) with rois at ``featmap_stride`` 16, 4 x 4 bins.

JAX's ``FastRCNN.setup`` tests ``isinstance(self.roi_head, dict)``, which
the ``FrozenDict`` flax hands it fails, so a JAX detector drops its shared
head (ROADMAP queue 3). ``jax_shared_heads`` repairs that check in the
JAX module for the references that need the head.

Tolerances (CPU readings in brackets): RoIAlign and the extractor 1e-6 of
the output's largest magnitude [1.2e-7, 1.2e-7]; RoIAlign's map gradient
1e-6 of its largest element [2.5e-7] (two products here, a scatter in JAX:
the order of the sums differs, and there is no atomic add on either side,
so the card adds no nondeterminism); the head's logits 1e-6, its loss and
metrics 1e-6 relative; detector eval logits 2e-5 of their largest
magnitude, as the 3D CNNs' [3.9e-7; 2.6e-7 with ACRN, 4.6e-7 with FBO];
the trajectory's losses 1e-5 relative [5.2e-6], every tensor after the
steps 1e-3 sum|diff| / sum|ref| [4.5e-7], running statistics 2e-5
[9.1e-7], as ``tests/test_torch_recognizer3d_cnn_train.py``; frame mAP
1e-6.
"""

import builtins
import collections.abc
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.nn.functional as F

import adapt_image_models_tpu.models.detectors.fast_rcnn as jax_fast_rcnn
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.heads.bbox_head import BBoxHeadAVA as JaxBBoxHead
from adapt_image_models_tpu.models.roi_extractors import (
    SingleRoIExtractor3D as JaxExtractor,
)
from adapt_image_models_tpu.ops.roi_align import roi_align as jax_roi_align
from adapt_image_models_torch.apis import run_detection_evaluation, train_model
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.detectors import FastRCNN
from adapt_image_models_torch.models.heads.bbox_head import BBoxHeadAVA
from adapt_image_models_torch.models.roi_extractors import SingleRoIExtractor3D
from adapt_image_models_torch.ops.roi_align import roi_align

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_ava_data import NUM_CLASSES, ava_dataset_cfg, write_ava_tree
from test_torch_resnet2d import _draw, _rel, _sum_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLOWONLY = dict(type="ResNet3dSlowOnly", depth=50, base_channels=8, stage_blocks=(1, 1, 1, 1),
                spatial_strides=(1, 2, 2, 1))
SLOWFAST = dict(type="ResNet3dSlowFast", alpha=4, base_channels=16, stage_blocks=(1, 1, 1, 1))


def _mapping_isinstance(obj, types):
    if types is dict:
        return builtins.isinstance(obj, collections.abc.Mapping)
    return builtins.isinstance(obj, types)


@pytest.fixture
def jax_shared_heads(monkeypatch):
    """JAX's FastRCNN with its ``isinstance(roi_head, dict)`` check
    reading flax's FrozenDict as the dict it is, so the shared head is
    built (``fast_rcnn.py:43-44``)."""
    monkeypatch.setattr(jax_fast_rcnn, "isinstance", _mapping_isinstance, raising=False)


def detector_cfg(backbone=SLOWONLY, in_channels=256, shared=None, dropout=0.0, **extractor):
    roi_head = dict(
        bbox_roi_extractor=dict(type="SingleRoIExtractor3D", featmap_stride=16, output_size=4,
                                **extractor),
        bbox_head=dict(type="BBoxHeadAVA", in_channels=in_channels, num_classes=NUM_CLASSES,
                       dropout_ratio=dropout, topk=(2, 3)))
    if shared:
        roi_head["shared_head"] = shared
    return dict(type="FastRCNN", backbone=dict(backbone), roi_head=roi_head,
                train_cfg=dict(rcnn=dict(pos_weight=1.0)),
                test_cfg=dict(rcnn=dict(action_thr=0.002)))


def detector_inputs(frames=4, batch=2, rois=3, size=32, lt=None, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, 3, frames, size, size)).astype(np.float32)
    xy = rng.uniform(-4, size - 8, (batch, rois, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, size, (batch, rois, 2))], -1)
    lt_feat = None if lt is None else rng.standard_normal((batch,) + lt).astype(np.float32)
    return x, boxes.astype(np.float32), lt_feat


def detector_pair(cfg, x, rois, lt_feat=None, seed=0):
    """The JAX detector of ``cfg``, seeded variables of its init on these
    inputs, and the port's detector with them."""
    jmodel = build_jax_model(dict(cfg))
    args = [jnp.asarray(x), jnp.asarray(rois)] + ([] if lt_feat is None else [jnp.asarray(lt_feat)])
    variables = _draw(jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), *args), seed)
    model = build_model(dict(cfg))
    model.load_state_dict(params_from_jax(variables), strict=True)
    return jmodel, variables, model


def _t(*arrays):
    return [None if a is None else torch.tensor(a) for a in arrays]


# ---- RoIAlign and the extractor ---------------------------------------------------

ROIS = np.array([[[0, 0, 100, 80], [-20, -10, 30, 40], [150, 150, 300, 300], [5, 7, 60, 33]],
                 [[0, 0, 192, 160], [100, 10, 190, 159], [-40, -40, -20, -20], [20, 30, 21, 31]]],
                np.float32)


@pytest.mark.parametrize("aligned,sampling_ratio", [(True, 0), (True, 3), (False, 0),
                                                    (False, 2)])
def test_roi_align_matches_jax(aligned, sampling_ratio):
    """Boxes touching the map's edges, past them, wholly outside, and
    thinner than a bin, forward and the gradient of a weighted sum with
    respect to the map, against JAX's gather and its VJP."""
    feat = np.random.default_rng(1).standard_normal((2, 10, 12, 5)).astype(np.float32)
    cot = np.random.default_rng(2).standard_normal((2, 4, 4, 4, 5)).astype(np.float32)

    def jfn(f):
        return jax_roi_align(f, jnp.asarray(ROIS), 4, 1 / 16, sampling_ratio, aligned)

    want, vjp = jax.vjp(jfn, jnp.asarray(feat))
    tf = torch.tensor(feat, requires_grad=True)
    got = roi_align(tf, torch.tensor(ROIS), 4, 1 / 16, sampling_ratio, aligned)
    assert _rel(got, want) < 1e-6
    (got * torch.tensor(cot)).sum().backward()
    assert _rel(tf.grad, vjp(jnp.asarray(cot))[0]) < 1e-6
    # the box wholly outside reads zero; the box past the corner does not
    got = got.detach()
    assert float(got[1, 2].abs().max()) == 0.0 and float(got[0, 1].abs().max()) > 0


def test_roi_align_bilinear_is_exact_on_a_ramp():
    """On a map whose value is its coordinate, each bin is its centre."""
    yy, xx = np.mgrid[0:16, 0:16].astype(np.float32)
    feat = torch.tensor(np.stack([xx, yy], -1)[None])
    out = roi_align(feat, torch.tensor([[[2.0, 4.0, 10.0, 12.0]]]), 4, 1.0, 2).numpy()
    np.testing.assert_allclose(out[0, 0, 0, :, 0], 2 + (np.arange(4) + 0.5) * 2 - 0.5, atol=1e-5)
    np.testing.assert_allclose(out[0, 0, :, 0, 1], 4 + (np.arange(4) + 0.5) * 2 - 0.5, atol=1e-5)


@pytest.mark.parametrize("mode,with_global,hw", [
    ("avg", False, (8, 10)), ("max", False, (8, 10)),
    ("avg", True, (16, 16)),  # a downscale by 2 on both axes: antialiased
    ("max", True, (12, 3)),   # 12 -> 4 shrinks, 3 -> 4 grows
])
def test_extractor_matches_jax(mode, with_global, hw):
    """The temporal pool, RoIAlign at stride 16 and ``with_global``'s
    resized map against JAX's extractor; at 16 -> 4 torch's bilinear
    ``interpolate`` is another function (the gap is kept below)."""
    rng = np.random.default_rng(3)
    feat = rng.standard_normal((2, 3) + hw + (6,)).astype(np.float32)
    rois = ROIS[:, :3]
    jext = JaxExtractor(featmap_stride=16, output_size=4, temporal_pool_mode=mode,
                        with_global=with_global)
    want = jext.apply({}, jnp.asarray(feat), jnp.asarray(rois))
    ext = SingleRoIExtractor3D(featmap_stride=16, output_size=4, temporal_pool_mode=mode,
                               with_global=with_global)
    got = ext(torch.tensor(feat), torch.tensor(rois))
    assert got.shape == want.shape == (2, 3, 4, 4, 12 if with_global else 6)
    assert _rel(got, want) < 1e-6
    if with_global and hw == (16, 16):
        plain = F.interpolate(torch.tensor(feat).mean(1).permute(0, 3, 1, 2), size=(4, 4),
                              mode="bilinear", align_corners=False)
        gap = _rel(plain.permute(0, 2, 3, 1), np.asarray(want)[:, 0, ..., 6:])
        assert gap > 1e-2, gap  # not JAX's resize: a departure the port does not take


# ---- the BBox head -------------------------------------------------------------------

@pytest.mark.parametrize("rank", [3, 5, 6])
@pytest.mark.parametrize("before", [True, False])
def test_bbox_head_logits_match_jax(rank, before):
    """(B, R, C) pooled, (B, R, O, O, C) and (B, R, T, O, O, C) inputs, each
    pool mode, in eval (dropout inactive either side of the pool)."""
    rng = np.random.default_rng(rank)
    shape = {3: (2, 3, 8), 5: (2, 3, 4, 4, 8), 6: (2, 3, 2, 4, 4, 8)}[rank]
    x = rng.standard_normal(shape).astype(np.float32)
    for tpool, spool in (("avg", "max"), ("max", "avg")):
        kw = dict(temporal_pool_type=tpool, spatial_pool_type=spool, in_channels=8,
                  num_classes=NUM_CLASSES, dropout_ratio=0.5, dropout_before_pool=before)
        jhead = JaxBBoxHead(**kw)
        params = _draw(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(x)), rank)
        head = BBoxHeadAVA(**kw).eval()
        head.load_state_dict({k[len("bbox_head."):]: v for k, v in params_from_jax(
            {"bbox_head_module": params["params"]}).items()})
        with torch.no_grad():
            assert _rel(head(torch.tensor(x)), jhead.apply(params, jnp.asarray(x))) < 1e-6


@pytest.mark.parametrize("gamma,alpha,topk", [(0.0, 1.0, (3, 5)), (1.0, 3.0, (2, 9))])
def test_bbox_head_loss_matches_jax(gamma, alpha, topk):
    """The focal BCE over classes 1..C-1 of the rows with a positive label
    and weight, with padded (weight 0) and negative rows, its gradient with
    respect to the scores, recall and precision at 0.5 and top-k (a k past
    the classes clamps, as JAX), against JAX's."""
    rng = np.random.default_rng(11)
    n = 12
    scores = (3 * rng.standard_normal((n, NUM_CLASSES))).astype(np.float32)
    labels = (rng.random((n, NUM_CLASSES)) < 0.4).astype(np.float32)
    labels[:, 0] = 0
    labels[3] = 0  # a negative row
    weights = np.ones(n, np.float32)
    weights[-4:] = 0  # padding
    kw = dict(focal_gamma=gamma, focal_alpha=alpha, num_classes=NUM_CLASSES, topk=topk)
    jhead = JaxBBoxHead(**kw)

    def jloss(s):
        return jhead.loss(s, jnp.asarray(labels), jnp.asarray(weights))

    (jl, jm), jgrad = jax.value_and_grad(jloss, has_aux=True)(jnp.asarray(scores))
    ts = torch.tensor(scores, requires_grad=True)
    loss, metrics = BBoxHeadAVA(**kw).loss(ts, torch.tensor(labels), torch.tensor(weights))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-6)
    assert _rel(ts.grad, jgrad) < 1e-6
    assert metrics.keys() == jm.keys()
    for k in metrics:
        assert float(metrics[k].detach()) == pytest.approx(float(jm[k]), rel=1e-6, abs=1e-7), k


# ---- the detector --------------------------------------------------------------------

FBO_NL = dict(type="FBOHead", fbo_cfg=dict(
    type="non_local", st_feat_channels=256, lt_feat_channels=16, latent_channels=32,
    num_non_local_layers=2, st_feat_dropout_ratio=0, lt_feat_dropout_ratio=0))


@pytest.mark.parametrize("name", ["slowonly", "slowonly_global_max", "slowfast_avg",
                                  "slowfast_max", "slowfast_acrn", "slowonly_fbo"])
def test_fast_rcnn_eval_matches_jax(name, jax_shared_heads):
    """FastRCNN's eval logits against JAX: SlowOnly (and ``with_global``,
    the context recipe's extractor), SlowFast's two pathways pooled over
    time with the extractor's mode and concatenated, ACRN (2 convs, stride
    2) over SlowFast's fused map and the non-local FBO over SlowOnly's with
    a (B, L, C) window each sample's rois share."""
    lt = None
    if name.startswith("slowfast"):
        acrn = name.endswith("acrn")
        cfg = detector_cfg(SLOWFAST, 32 if acrn else 576,
                           temporal_pool_mode="max" if acrn else name.split("_")[1],
                           shared=dict(type="ACRNHead", in_channels=1152, out_channels=32,
                                       num_convs=2, stride=2) if acrn else None)
        x, rois, _ = detector_inputs(frames=8)
    elif name == "slowonly_fbo":
        cfg = detector_cfg(in_channels=288, shared=FBO_NL)
        x, rois, lt = detector_inputs(lt=(6, 16))
    else:
        glob = name != "slowonly"
        cfg = detector_cfg(in_channels=512 if glob else 256, with_global=glob,
                           temporal_pool_mode="max" if glob else "avg")
        x, rois, _ = detector_inputs()
    jmodel, variables, model = detector_pair(cfg, x, rois, lt)
    assert ("shared_head_module" in variables["params"]) == (
        name in ("slowfast_acrn", "slowonly_fbo"))
    model.eval()
    with torch.no_grad():
        got = model(*_t(x, rois, lt))
    want = jax.jit(jmodel.apply)(variables, *(jnp.asarray(a) for a in (x, rois)
                                              + (() if lt is None else (lt,))))
    assert got.shape == (2, 3, NUM_CLASSES)
    assert _rel(got, want) < 2e-5


# ---- train_model on a detector config, and evaluation --------------------------------

@pytest.fixture(scope="module")
def ava_root(tmp_path_factory):
    return write_ava_tree(tmp_path_factory.mktemp("ava_det"))


def train_cfg(root, work_dir, model=None, total_epochs=2):
    return dict(
        model=model or detector_cfg(),
        data=dict(videos_per_gpu=1, workers_per_gpu=1,
                  train=ava_dataset_cfg(root), val=ava_dataset_cfg(root, test_mode=True)),
        optimizer=dict(type="SGD", lr=0.2, momentum=0.9, weight_decay=1e-5),
        optimizer_config=dict(grad_clip=dict(max_norm=0.5)),  # binds
        lr_config=dict(policy="step", step=[1], warmup="linear", warmup_by_epoch=True,
                       warmup_iters=1, warmup_ratio=0.1),
        total_epochs=total_epochs, checkpoint_config=dict(interval=1),
        log_config=dict(interval=1), work_dir=str(work_dir))


def jax_detection_run(cfg, variables, steps, lfb=None):
    """JAX's detection step (``make_detection_train_step``) over the
    samples its loader gives at seed 0 (and the windows ``lfb`` samples
    for them, as JAX's ``train_detector``): the losses, the final state as
    the port's state dict and the trainable tree."""
    from adapt_image_models_tpu.apis.detection import (
        _sample_lt_feat, make_det_prepare_fn, make_detection_train_step,
    )
    from adapt_image_models_tpu.core.optim import build_optimizer
    from adapt_image_models_tpu.core.schedule import build_schedule
    from adapt_image_models_tpu.core.train_state import create_train_state
    from adapt_image_models_tpu.data.datasets import build_dataset
    from adapt_image_models_tpu.data.loader import VideoLoader
    from adapt_image_models_tpu.parallel.partition import partition_params
    jmodel = build_jax_model(dict(cfg["model"]))
    ds = build_dataset(dict(cfg["data"]["train"]))
    loader = VideoLoader(ds, ds.pipeline, batch_size=1, shuffle=True, seed=0, num_workers=1,
                         drop_last=True)
    schedule = build_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], cfg["total_epochs"],
                              len(loader))
    trainable, _ = partition_params(variables["params"])
    tx = build_optimizer(cfg["optimizer"], trainable, schedule,
                         grad_clip=cfg["optimizer_config"]["grad_clip"]["max_norm"])
    state = create_train_state(variables["params"], tx, model_state={
        k: v for k, v in variables.items() if k != "params"})
    step = jax.jit(make_detection_train_step(jmodel, tx, make_det_prepare_fn(ds.mean, ds.std)))
    losses = []
    for epoch in range(cfg["total_epochs"]):
        loader.set_epoch(epoch)
        for batch in loader:
            if lfb is not None:
                batch["lt_feat"] = _sample_lt_feat(lfb, batch["img_key"])
            state, metrics = step(state, {k: v for k, v in batch.items()
                                          if not isinstance(v, list)}, jax.random.PRNGKey(1))
            losses.append(float(metrics["loss"]))
    assert len(losses) == steps
    return losses, params_from_jax({"params": state.params, **state.model_state}), trainable


def _load_into_init(monkeypatch, variables):
    """``FastRCNN.init_weights`` loads ``variables`` (the JAX draw), so
    ``train_model`` starts where JAX's step does."""
    sd = params_from_jax(variables)
    monkeypatch.setattr(FastRCNN, "init_weights",
                        lambda self, generator: self.load_state_dict(sd, strict=True))


def test_train_model_detector_matches_jax_and_resumes(ava_root, tmp_path, monkeypatch):
    """``train_model`` dispatches the detector config to ``train_detector``:
    four SGD steps (two epochs of the fixture's two keyframes) with
    momentum, weight decay, a binding clip and the warmup schedule,
    against JAX's step on the same samples and weights: losses, every
    tensor and BatchNorm statistic. Every tensor trains, as JAX's
    ``partition_params`` leaves every detector tensor trainable. Then a
    run cut after epoch 1 and auto-resumed from its checkpoint ends
    bit-equal to the uninterrupted one."""
    cfg = train_cfg(ava_root, tmp_path / "full")
    x, rois, _ = detector_inputs()
    jmodel, variables, _ = detector_pair(cfg["model"], x, rois)
    want_losses, want, trainable = jax_detection_run(cfg, variables, 4)
    _load_into_init(monkeypatch, variables)
    state, history = train_model(cfg, validate=False, seed=0, max_steps=4, device="cpu")
    assert [h["iter"] for h in history] == [1, 2, 1, 2]
    assert {"recall@thr=0.5", "prec@top2", "grad_norm"} <= history[0].keys()
    np.testing.assert_allclose([h["loss"] for h in history], want_losses, rtol=1e-5)
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert _sum_rel(got[k], v) < (2e-5 if "running" in k else 1e-3), k
    n_trainable = len(jax.tree_util.tree_leaves(trainable))
    assert n_trainable == len(state.optimizer.params) == len(list(state.model.parameters()))

    cut = train_cfg(ava_root, tmp_path / "cut")
    train_model(cut, validate=False, seed=0, max_steps=2, device="cpu")
    resumed, rest = train_model(cut, validate=False, seed=0, auto_resume=True, device="cpu")
    assert [h["epoch"] for h in rest] == [1, 1] and resumed.step == 4
    for k, v in resumed.model.state_dict().items():
        assert torch.equal(v, got[k]), k


def test_detection_evaluation_matches_jax(ava_root, tmp_path):
    """``run_detection_evaluation`` on the fixture's three val keyframes
    (the 32 x 48 canvas): the frame mAP and every class's AP against JAX's
    ``run_detection_evaluation`` with the same weights."""
    from adapt_image_models_tpu.apis.detection import (
        run_detection_evaluation as jax_run_detection_evaluation,
    )
    from adapt_image_models_tpu.parallel.mesh import make_mesh
    cfg = train_cfg(ava_root, tmp_path)
    x, rois, _ = detector_inputs()
    jmodel, variables, model = detector_pair(cfg["model"], x, rois, seed=3)
    got = run_detection_evaluation(cfg, model, split="val")
    want = jax_run_detection_evaluation(cfg, jmodel, variables, split="val",
                                        mesh=make_mesh(data=2, model=4))
    assert got.keys() == want.keys() and "mAP@0.5IOU" in got
    for k in got:
        assert got[k] == pytest.approx(want[k], abs=1e-6), k
    assert 0.0 <= got["mAP@0.5IOU"] <= 1.0


def test_train_detector_stops_on_sigterm_and_the_cli_takes_a_detector(ava_root, tmp_path,
                                                                      monkeypatch):
    """A SIGTERM (the guard's event set) stops ``train_detector`` at the
    first step boundary with that epoch checkpointed, as ``train_model``;
    ``tools/train_torch.py`` runs a detector config file as it is."""
    import contextlib
    import json
    import sys
    import threading

    import adapt_image_models_torch.apis.train as port_train
    from adapt_image_models_torch.core.checkpoint import CheckpointManager

    @contextlib.contextmanager
    def preempted():
        event = threading.Event()
        event.set()
        yield event

    cfg = train_cfg(ava_root, tmp_path / "stop")
    with monkeypatch.context() as m:
        m.setattr(port_train, "preemption_guard", preempted)
        state, history = train_model(cfg, validate=False, seed=0, device="cpu")
    assert state.step == 1 and history == []
    assert CheckpointManager(str(tmp_path / "stop")).latest_epoch() == 0

    path = tmp_path / "det_cfg.py"
    path.write_text("\n".join(f"{k} = {v!r}" for k, v in
                              train_cfg(ava_root, tmp_path / "cli").items()))
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import train_torch
    finally:
        sys.path.pop(0)
    state, history = train_torch.main([str(path), "--device", "cpu", "--max-steps", "1",
                                       "--no-validate"])
    assert state.step == 1 and len(history) == 1
    with open(tmp_path / "cli" / "history.json") as f:
        assert json.load(f)[0]["loss"] == history[0]["loss"]


def test_detection_evaluation_sharded_by_rank_equals_one_process(ava_root, tmp_path,
                                                                 monkeypatch):
    """Under a process group each rank scores its shard of the split (the
    loader's ``padded[rank::W]``) and the gathered rows are put back in
    dataset order: two ranks' halves of the fixture's 3 keyframes, the
    all_gather stood in for by each rank's own rows, give the one-process
    metrics exactly."""
    import adapt_image_models_torch.apis.detection as det
    cfg = train_cfg(ava_root, tmp_path)
    x, rois, _ = detector_inputs()
    _, _, model = detector_pair(cfg["model"], x, rois, seed=3)
    want = run_detection_evaluation(cfg, model, split="val")
    shards = {}

    def gather(local):
        shards[len(shards)] = local
        return torch.cat([shards[1], shards[0]]) if len(shards) == 2 else local.repeat(2, 1)

    monkeypatch.setattr(det, "all_gather_rows", gather)
    for rank in (1, 0):
        monkeypatch.setattr(det, "get_dist_info", lambda r=rank: (r, 2))
        got = run_detection_evaluation(cfg, model, split="val")
    assert got == want
    with pytest.raises(ValueError, match="one process"):
        train_model(cfg, validate=False, device="cpu")
