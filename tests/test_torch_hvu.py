"""HVU of the PyTorch port against the JAX package: ``HVUDataset``'s
multi-hot labels, tag masks, category masks and per-category mAP;
``HVULoss`` in its ``all`` and ``individual`` forms, with and without
masks, and its gradients; and the train step's mask wiring: two steps of
``train_model`` on the shipped TSN-R18 HVU recipe with its loss set to
``HVULoss`` and its data to ``HVUDataset`` against JAX's
``make_train_step`` (whose custom loss reads the batch's ``mask`` /
``category_mask`` and is optimised by its ``loss_cls``) on the same
batches and weights.

The recipe is ``configs/recognition/tsn/hvu/tsn_r18_1x1x8_100e_hvu_action_rgb.py``
as shipped but for sizes: the ResNet-18 toy of
``tests/test_torch_recognizer2d_train.py`` (one block a stage, base width
16), 3 categories of 4, 6 and 3 tags, 4 segments resized to 40 and
cropped to 32², no dropout (the packages draw it from different
generators), over rawframe videos written here. JAX's loader cannot read
an HVU sample (its label is a dict of tag lists), so its step takes the
batches of the port's loader.

Tolerances (CPU readings in brackets): labels, masks and mAP exact; loss
values and score gradients 1e-6 relative [1.0e-7, 7.9e-8]; the
trajectory's losses 1e-5 relative, tensors after the steps 1e-3 sum|diff|
/ sum|ref|, running statistics 2e-5, as
``tests/test_torch_recognizer2d_train.py`` [2.5e-7, 1.4e-7 and 1.3e-6 at
most over this file's and ``tests/test_torch_lfb_acrn.py``'s runs].
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.data.hvu_dataset import HVUDataset as JaxHVUDataset
from adapt_image_models_tpu.models.losses.hvu_loss import HVULoss as JaxHVULoss
from adapt_image_models_torch.apis import load_config, train_model
from adapt_image_models_torch.core.train_state import loss_mask_keys
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.models.losses import HVULoss
from adapt_image_models_torch.models.recognizers.recognizer2d import Recognizer2D

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _draw, _rel, _sum_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CATS = ("action", "object", "scene")
NUMS = (4, 6, 3)
LABELS = [dict(action=[0, 2], object=[5], scene=[1]), dict(action=[1], object=[0, 3]),
          dict(scene=[2]), dict(action=[3], object=[1], scene=[0])]


def write_hvu(root, rawframes=False):
    """An HVU json of four videos (labelled in all, two and one categories),
    and for ``rawframes`` their 12 jpg frames at 48 x 40."""
    annos = []
    for i, label in enumerate(LABELS):
        if rawframes:
            import cv2
            d = root / f"v{i}"
            d.mkdir(parents=True)
            rng = np.random.default_rng(i)
            for f in range(1, 13):
                cv2.imwrite(str(d / f"img_{f:05}.jpg"),
                            rng.integers(0, 255, (40, 48, 3), dtype=np.uint8))
            annos.append(dict(frame_dir=f"v{i}", total_frames=12, label=label))
        else:
            annos.append(dict(filename=f"v{i}.mp4", label=label))
    path = root / ("hvu_frames.json" if rawframes else "hvu.json")
    path.write_text(json.dumps(annos))
    return str(path)


@pytest.mark.parametrize("rawframes", [False, True])
def test_hvu_dataset_matches_jax(tmp_path, rawframes):
    """Every info of both packages (paths under ``data_prefix``, the
    multi-hot label, the tag mask over the categories a video is labelled
    in, the category mask), and ``evaluate`` on random scores and on
    perfect ones (every category's mAP 1)."""
    kw = dict(ann_file=write_hvu(tmp_path, rawframes), tag_categories=CATS,
              tag_category_nums=NUMS, data_prefix=str(tmp_path),
              **({"filename_tmpl": "img_{:05}.jpg", "start_index": 1} if rawframes else {}))
    ds, jds = build_dataset(dict(kw, type="HVUDataset")), JaxHVUDataset(**kw)
    assert len(ds) == len(jds) == 4 and ds.num_tags == 13
    for a, b in zip(ds.video_infos, jds.video_infos):
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], np.ndarray):
                np.testing.assert_array_equal(a[k], b[k])
            else:
                assert a[k] == b[k], k
    assert ds[1]["category_mask"].tolist() == [1, 1, 0] and ds[1]["mask"][10:].sum() == 0
    rng = np.random.default_rng(3)
    results = [rng.standard_normal(13) for _ in range(4)]
    assert ds.evaluate(results) == jds.evaluate(results)
    perfect = ds.evaluate([info["label_onehot"] * 10 - 5 for info in ds.video_infos])
    assert perfect == {"action_mAP": 1.0, "object_mAP": 1.0, "scene_mAP": 1.0,
                       "overall_mAP": 1.0}
    with pytest.raises(ValueError):
        ds.evaluate(results[:3])


@pytest.mark.parametrize("loss_type,with_mask,reduction", [
    ("all", False, "mean"), ("all", False, "sum"), ("all", True, "mean"), ("all", True, "sum"),
    ("individual", False, "mean"), ("individual", True, "mean"), ("individual", True, "sum")])
def test_hvu_loss_matches_jax(tmp_path, loss_type, with_mask, reduction):
    """Every key of the loss dict and the scores' gradient of ``loss_cls``,
    on the dataset's labels and masks (a category no video is labelled in
    weighs in at 0), with unequal category weights, against JAX's."""
    ds = build_dataset(dict(type="HVUDataset", ann_file=write_hvu(tmp_path),
                            tag_categories=CATS, tag_category_nums=NUMS))
    label = np.stack([i["label_onehot"] for i in ds.video_infos])
    mask = np.stack([i["mask"] for i in ds.video_infos])
    cmask = np.stack([i["category_mask"] for i in ds.video_infos])
    cmask[:, 2] = 0  # no video labelled in 'scene'
    scores = (3 * np.random.default_rng(2).standard_normal((4, 13))).astype(np.float32)
    kw = dict(categories=CATS, category_nums=NUMS, category_loss_weights=(1.0, 2.0, 0.5),
              loss_type=loss_type, with_mask=with_mask, reduction=reduction, loss_weight=3.0)
    jloss = JaxHVULoss(**kw)
    loss = HVULoss(**kw)
    assert loss_mask_keys(loss) == ("mask", "category_mask")
    masks = dict(mask=mask, category_mask=cmask) if with_mask else {}

    def jfn(s):
        out = jloss(s, jnp.asarray(label), **{k: jnp.asarray(v) for k, v in masks.items()})
        return out["loss_cls"], out

    (_, want), jgrad = jax.value_and_grad(jfn, has_aux=True)(jnp.asarray(scores))
    ts = torch.tensor(scores, requires_grad=True)
    got = loss(ts, torch.tensor(label), **{k: torch.tensor(v) for k, v in masks.items()})
    got["loss_cls"].backward()
    assert got.keys() == want.keys()
    for k in got:
        assert float(got[k].detach()) == pytest.approx(float(want[k]), rel=1e-6), k
    assert _rel(ts.grad, jgrad) < 1e-6
    if with_mask:
        with pytest.raises(ValueError):
            loss(ts, torch.tensor(label))


def hvu_recipe(root, work_dir):
    """The shipped HVU TSN-R18 recipe, cut to size, with HVULoss (individual,
    masked) and HVUDataset."""
    cfg = load_config(os.path.join(ROOT, "configs/recognition/tsn/hvu",
                                   "tsn_r18_1x1x8_100e_hvu_action_rgb.py"))
    head = dict(cfg["model"]["cls_head"], in_channels=128, num_classes=sum(NUMS),
                dropout_ratio=0.0,
                loss_cls=dict(type="HVULoss", categories=CATS, category_nums=NUMS,
                              loss_type="individual", with_mask=True, loss_weight=3.0))
    cfg["model"] = dict(cfg["model"], cls_head=head, backbone=dict(
        type="ResNet", depth=18, stage_blocks=(1, 1, 1, 1), base_channels=16))
    pipeline = []
    for step in cfg["data"]["train"]["pipeline"]:
        step = dict(step)
        if step["type"] == "SampleFrames":
            step["num_clips"] = 4
        if step["type"] == "Resize":
            step["scale"] = (-1, 40) if step["scale"][0] == -1 else (32, 32)
        pipeline.append(step)
    cfg["data"] = dict(cfg["data"], videos_per_gpu=2, workers_per_gpu=1, train=dict(
        type="HVUDataset", ann_file=write_hvu(root, rawframes=True), data_prefix=str(root),
        tag_categories=CATS, tag_category_nums=NUMS, filename_tmpl="img_{:05}.jpg",
        start_index=1, pipeline=pipeline))
    cfg.update(total_epochs=1, log_config=dict(interval=1), work_dir=str(work_dir))
    return cfg


def test_hvu_recipe_train_model_matches_jax(tmp_path, monkeypatch):
    """Two steps of ``train_model`` (SGD with momentum, weight decay and the
    recipe's clip of 40) against JAX's ``make_train_step`` with the same
    optimizer on the port loader's batches: the losses (HVULoss's
    ``loss_cls``, each category masked by the batch's ``category_mask``),
    every tensor and running statistic."""
    from adapt_image_models_tpu.core.optim import build_optimizer
    from adapt_image_models_tpu.core.schedule import build_schedule
    from adapt_image_models_tpu.core.train_state import create_train_state, make_train_step
    from adapt_image_models_tpu.data.transforms import make_prepare_fn
    from adapt_image_models_tpu.models import build_model as build_jax_model
    from adapt_image_models_tpu.parallel.partition import partition_params
    from adapt_image_models_torch.convert import params_from_jax
    cfg = hvu_recipe(tmp_path, tmp_path / "work")
    jmodel = build_jax_model(dict(cfg["model"]))
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 4, 3, 32, 32), jnp.float32))
    variables = _draw(tree, 0)
    sd = params_from_jax(variables)
    monkeypatch.setattr(Recognizer2D, "init_weights",
                        lambda self, generator: self.load_state_dict(sd, strict=True))
    state, history = train_model(cfg, validate=False, seed=0, max_steps=2, device="cpu")

    ds = build_dataset(dict(cfg["data"]["train"]))
    loader = VideoLoader(ds, None, batch_size=2, shuffle=True, seed=0, num_workers=1,
                         drop_last=True)
    trainable, _ = partition_params(variables["params"])
    schedule = build_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], 1, len(loader))
    tx = build_optimizer(cfg["optimizer"], trainable, schedule, grad_clip=40)
    jstate = create_train_state(variables["params"], tx,
                                model_state={"batch_stats": variables["batch_stats"]})
    norm = [s for s in cfg["data"]["train"]["pipeline"] if s["type"] == "Normalize"][0]
    step = jax.jit(make_train_step(jmodel, tx, make_prepare_fn(norm["mean"], norm["std"],
                                                               layout="NCHW")))
    losses = []
    loader.set_epoch(0)
    for batch in loader:
        assert batch["label"].shape == (2, 13) and batch["category_mask"].shape == (2, 3)
        jstate, metrics = step(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                               jax.random.PRNGKey(1))
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose([h["loss"] for h in history], losses, rtol=1e-5)
    want = params_from_jax({"params": jstate.params, **jstate.model_state})
    got = state.model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        assert _sum_rel(got[k], v) < (2e-5 if "running" in k else 1e-3), k
