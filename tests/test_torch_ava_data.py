"""The AVA data stage and metrics of the PyTorch port against the JAX
package: the box utilities (``core/bbox.py``), ``AVADataset``'s parsing
(the merged multi-hot labels, the exclude file's zero-padded timestamps,
``custom_classes``, the label map), ``prepare_sample`` for train and test
at one seed, frame mAP (``core/ava_eval.py``), the AVA csv rows and
ActivityNet's detection mAP (``core/eval_detection.py``).

The fixture is ``tests/test_data/test_ava.py``'s: two videos of 120 jpg
frames at 64 x 48, five annotation rows over three keyframes (one
excluded), a 4-class label map and dense proposals, written here. Every
comparison is exact (bit for bit on arrays, equal on floats) unless it
says otherwise: both packages run the same numpy on the same pixels.
"""

import json
import pickle

import numpy as np
import pytest

from adapt_image_models_tpu.core import ava_eval as jax_ava_eval
from adapt_image_models_tpu.core import bbox as jax_bbox
from adapt_image_models_tpu.core.eval_detection import (
    ActivityNetDetection as JaxActivityNetDetection,
)
from adapt_image_models_tpu.data.datasets import build_dataset as build_jax_dataset
from adapt_image_models_torch.core import ava_eval, bbox
from adapt_image_models_torch.core.eval_detection import ActivityNetDetection
from adapt_image_models_torch.data.datasets import build_dataset

NUM_CLASSES = 5  # 4 actions and the reserved class 0


def write_ava_tree(root):
    """The JAX fixture's AVA tree under ``root``; returns ``root``."""
    import cv2
    rng = np.random.default_rng(0)
    for vid in ("vidA", "vidB"):
        d = root / "rawframes" / vid
        d.mkdir(parents=True)
        for i in range(1, 121):
            cv2.imwrite(str(d / f"img_{i:05}.jpg"),
                        rng.integers(0, 255, (48, 64, 3), dtype=np.uint8))
    # video_id,timestamp,x1,y1,x2,y2,action_id,entity_id (normalised)
    (root / "train.csv").write_text("\n".join([
        "vidA,902,0.10,0.10,0.60,0.80,1,0",
        "vidA,902,0.10,0.10,0.60,0.80,3,0",
        "vidA,902,0.55,0.20,0.95,0.90,2,1",
        "vidB,903,0.20,0.15,0.70,0.85,4,0",
        "vidB,904,0.30,0.20,0.80,0.90,1,0",
    ]))
    (root / "exclude.csv").write_text("vidB,0904\n")  # zero-padded, as the official files
    (root / "labelmap.pbtxt").write_text("\n".join(
        line for i, name in enumerate(("stand", "sit", "walk", "run"), 1)
        for line in ("item {", f'  name: "{name}"', f"  id: {i}", "}")) + "\n")
    proposals = {
        "vidA,0902": np.array([[0.12, 0.12, 0.58, 0.78, 0.99],
                               [0.50, 0.22, 0.93, 0.88, 0.95],
                               [0.01, 0.01, 0.20, 0.20, 0.30]], np.float32),
        "vidB,0903": np.array([[0.22, 0.17, 0.68, 0.83, 0.97]], np.float32),
    }
    with open(root / "proposals.pkl", "wb") as f:
        pickle.dump(proposals, f)
    return root


def ava_dataset_cfg(root, test_mode=False, **kw):
    """The JAX fixture's dataset config (a 32² crop of 4 frames)."""
    pipeline = [dict(type="SampleAVAFrames", clip_len=4, frame_interval=2),
                dict(type="RawFrameDecode")]
    if test_mode:
        pipeline += [dict(type="Resize", scale=(-1, 32))]
    else:
        pipeline += [dict(type="RandomRescale", scale_range=(32, 40)),
                     dict(type="RandomCrop", size=32), dict(type="Flip", flip_ratio=0.5)]
    pipeline += [dict(type="Normalize", mean=[0, 0, 0], std=[255, 255, 255]),
                 dict(type="FormatShape", input_format="NCTHW")]
    return dict(type="AVADataset", ann_file=str(root / "train.csv"),
                exclude_file=str(root / "exclude.csv"), label_file=str(root / "labelmap.pbtxt"),
                proposal_file=str(root / "proposals.pkl"), data_prefix=str(root / "rawframes"),
                num_classes=NUM_CLASSES, timestamp_start=900, timestamp_end=904,
                person_det_score_thr=0.5, num_rois=8, test_mode=test_mode,
                **({"test_pad_to": (32, 48)} if test_mode else {}), pipeline=pipeline, **kw)


@pytest.fixture(scope="module")
def ava_root(tmp_path_factory):
    return write_ava_tree(tmp_path_factory.mktemp("ava"))


def _boxes(rng, n):
    xy = rng.uniform(0, 50, (n, 2))
    return np.concatenate([xy, xy + rng.uniform(1, 30, (n, 2))], 1).astype(np.float32)


def test_bbox_utils_match_jax():
    """IoU, the max-IoU assignment (multi-hot labels, each gt claiming its
    best proposals), the random sampler's draws from one seed, the
    fixed-shape targets and bbox2result, against JAX's on the same boxes."""
    rng = np.random.default_rng(3)
    gt, props = _boxes(rng, 4), _boxes(rng, 12)
    props[:3] = gt[:3] + rng.uniform(-0.5, 0.5, (3, 4)).astype(np.float32)
    labels = (rng.random((4, NUM_CLASSES)) < 0.4).astype(np.float32)
    np.testing.assert_array_equal(bbox.bbox_overlaps(gt, props), jax_bbox.bbox_overlaps(gt, props))
    for thr in (0.5, 0.9):
        kw = dict(pos_iou_thr=thr, neg_iou_thr=thr, min_pos_iou=thr)
        got = bbox.assign_max_iou(props, gt, labels, **kw)
        want = jax_bbox.assign_max_iou(props, gt, labels, **kw)
        np.testing.assert_array_equal(got.gt_inds, want.gt_inds)
        np.testing.assert_array_equal(got.labels, want.labels)
        for num, frac, ub in ((4, 1.0, -1.0), (8, 0.25, 1.0), (32, 1.0, -1.0)):
            s = bbox.random_sample(got, props, num, frac, ub, rng=np.random.default_rng(5))
            w = jax_bbox.random_sample(want, props, num, frac, ub, rng=np.random.default_rng(5))
            np.testing.assert_array_equal(s.pos_inds, w.pos_inds)
            np.testing.assert_array_equal(s.neg_inds, w.neg_inds)
            for a, b in zip(bbox.bbox_target(s, NUM_CLASSES, 6, 2.0),
                            jax_bbox.bbox_target(w, NUM_CLASSES, 6, 2.0)):
                np.testing.assert_array_equal(a, b)
    empty = bbox.assign_max_iou(props, gt[:0], labels[:0])
    assert (empty.gt_inds == 0).all()
    scores = rng.random((5, NUM_CLASSES)).astype(np.float32)
    for a, b in zip(bbox.bbox2result(props[:5], scores, NUM_CLASSES, 0.3),
                    jax_bbox.bbox2result(props[:5], scores, NUM_CLASSES, 0.3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("test_mode", [False, True])
def test_dataset_parsing_matches_jax(ava_root, test_mode):
    """The infos of both packages: merged same-box records, the exclude
    file (its 'vidB,0904' drops the 904 keyframe, in train mode only), the
    label map, custom_classes' remap and its refusals."""
    cfg = ava_dataset_cfg(ava_root, test_mode)
    ds, jds = build_dataset(dict(cfg)), build_jax_dataset(dict(cfg))
    assert len(ds) == len(jds) == (3 if test_mode else 2)
    for a, b in zip(ds.video_infos, jds.video_infos):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    info = ds[0]
    assert info["img_key"] == "vidA,0902" and info["gt_bboxes"].shape == (2, 4)
    assert info["gt_labels"][0, [1, 3]].tolist() == [1.0, 1.0]
    assert ((ds.mean, ds.std, ds.clip_len, ds.frame_interval)
            == (jds.mean, jds.std, jds.clip_len, jds.frame_interval))
    with open(ava_root / "labelmap.pbtxt") as f:
        got = ava_eval.read_labelmap(f)
    with open(ava_root / "labelmap.pbtxt") as f:
        assert got == jax_ava_eval.read_labelmap(f)
    assert got[1] == {1, 2, 3, 4} and got[0][0]["name"] == "stand"
    custom = dict(cfg, num_classes=3, custom_classes=[1, 4])
    ds_c, jds_c = build_dataset(dict(custom)), build_jax_dataset(dict(custom))
    for a, b in zip(ds_c.video_infos, jds_c.video_infos):
        np.testing.assert_array_equal(a["gt_labels"], b["gt_labels"])
    for bad in (dict(cfg, num_classes=3, custom_classes=[1, 9]),
                dict(cfg, custom_classes=[1, 4]), dict(cfg, person_det_score_thr=1.5)):
        with pytest.raises(ValueError):
            build_dataset(dict(bad))
    with pytest.raises(KeyError):
        build_dataset(dict(cfg, pipeline=[dict(type="ThreeCrop")]))


@pytest.mark.parametrize("test_mode", [False, True])
def test_prepare_sample_matches_jax(ava_root, test_mode):
    """Each keyframe's sample from one seed, bit for bit: the jittered
    frame indices, rescale, crop and flip (train), the short-side resize
    padded onto the 32 x 48 canvas (test), the proposals above the score
    threshold, the assigned and sampled rois, labels and weights."""
    cfg = ava_dataset_cfg(ava_root, test_mode)
    ds, jds = build_dataset(dict(cfg)), build_jax_dataset(dict(cfg))
    for idx in range(len(ds)):
        for seed in (0, 7):
            got = ds.prepare_sample(idx, np.random.default_rng(seed))
            want = jds.prepare_sample(idx, np.random.default_rng(seed))
            assert got.keys() == want.keys()
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])
    s = ds.prepare_sample(0, np.random.default_rng(0))
    if test_mode:
        assert s["imgs"].shape == (4, 32, 48, 3) and s["roi_weights"].sum() == 2
        assert s["img_shape"].tolist() == [32, 43]  # 64 x 48 to a short side of 32
    else:
        assert s["imgs"].shape == (4, 32, 32, 3) and s["rois"].shape == (8, 4)
        pos = s["labels"].sum(-1) > 0
        assert pos.any() and (s["roi_weights"][pos] > 0).all()


def _frame_map_case():
    gt_boxes = np.array([[0.1, 0.1, 0.5, 0.5], [0.6, 0.6, 0.9, 0.9]], np.float32)
    gt_labels = np.zeros((2, NUM_CLASSES), np.float32)
    gt_labels[0, 1] = gt_labels[1, 2] = 1
    scores = np.zeros((2, NUM_CLASSES), np.float32)
    scores[0, 1], scores[1, 2] = 0.9, 0.8
    return {"v,0001": (gt_boxes, gt_labels)}, gt_boxes, scores


def test_frame_map_perfect_partial_and_random_match_jax():
    """Perfect detections score 1; a misplaced class-2 box halves the mAP;
    random detections over several frames equal JAX's APs."""
    gts, boxes, scores = _frame_map_case()
    assert ava_eval.eval_frame_map({"v,0001": (boxes, scores)}, gts,
                                   NUM_CLASSES)["mAP@0.5IOU"] == pytest.approx(1.0)
    moved = boxes.copy()
    moved[1] = [0.0, 0.0, 0.05, 0.05]
    assert ava_eval.eval_frame_map({"v,0001": (moved, scores)}, gts,
                                   NUM_CLASSES)["mAP@0.5IOU"] == pytest.approx(0.5)
    rng = np.random.default_rng(4)
    dets, gts = {}, {}
    for f in range(6):
        g = _boxes(rng, 3) / 80
        gts[f"v,{f:04d}"] = (g, (rng.random((3, NUM_CLASSES)) < 0.5).astype(np.float32))
        d = np.concatenate([g + rng.normal(0, 0.02, g.shape), _boxes(rng, 2) / 80])
        dets[f"v,{f:04d}"] = (d.astype(np.float32), rng.random((5, NUM_CLASSES)))
    for thr in (0.3, 0.5):
        got = ava_eval.eval_frame_map(dets, gts, NUM_CLASSES, iou_thr=thr)
        assert got == jax_ava_eval.eval_frame_map(dets, gts, NUM_CLASSES, iou_thr=thr)
        assert 0.0 < got[f"mAP@{thr}IOU"] < 1.0


def test_results2csv_rows_match_jax():
    rng = np.random.default_rng(6)
    results = [bbox.bbox2result(_boxes(rng, 3) / 60, rng.random((3, NUM_CLASSES)),
                                NUM_CLASSES, 0.2) for _ in range(2)]
    keys = ["vidA,0902", "vidB,903"]
    rows = ava_eval.results2csv_rows(keys, results)
    assert rows == jax_ava_eval.results2csv_rows(keys, results)
    assert rows and all(r.split(",")[1] in ("0902", "0903") for r in rows)


def test_dataset_evaluate_matches_jax(ava_root):
    """``evaluate`` of per-sample results on the test canvas (pixel boxes,
    normalised by each sample's image shape, padded rois masked out)."""
    cfg = ava_dataset_cfg(ava_root, test_mode=True)
    ds, jds = build_dataset(dict(cfg)), build_jax_dataset(dict(cfg))
    rng = np.random.default_rng(8)
    results = []
    for idx in range(len(ds)):
        s = ds.prepare_sample(idx, rng)
        results.append({"img_key": s["img_key"], "boxes": s["rois"],
                        "scores": rng.random((8, NUM_CLASSES)).astype(np.float32),
                        "mask": s["roi_weights"], "img_shape": s["img_shape"]})
    got = ds.evaluate(results)
    assert got == jds.evaluate(results) and 0.0 <= got["mAP@0.5IOU"] <= 1.0


def test_activitynet_detection_matches_jax(tmp_path):
    """Detection mAP over tIoU thresholds: perfect, shifted (alive at 0.5,
    half at 0.95) and a random set of predictions, equal to JAX's."""
    gt = {"v_abc": dict(annotations=[dict(segment=[1.0, 4.0], label="Surf")]),
          "v_def": dict(annotations=[dict(segment=[2.0, 6.0], label="Dive"),
                                     dict(segment=[8.0, 9.5], label="Surf")])}
    rng = np.random.default_rng(9)
    preds = [dict(results={"abc": [dict(segment=[1.0, 4.0], label="Surf", score=0.9)],
                           "def": [dict(segment=[2.0, 6.0], label="Dive", score=0.8),
                                   dict(segment=[8.0, 9.5], label="Surf", score=0.7)]}),
             dict(results={"abc": [dict(segment=[1.0, 3.0], label="Surf", score=0.9)],
                           "def": [dict(segment=[2.0, 6.0], label="Dive", score=0.8),
                                   dict(segment=[8.0, 9.5], label="Surf", score=0.7)]}),
             dict(results={v: [dict(segment=sorted(rng.uniform(0, 10, 2).tolist()),
                                    label=str(rng.choice(["Surf", "Dive"])),
                                    score=float(rng.random())) for _ in range(5)]
                           for v in ("abc", "def")})]
    gtf = tmp_path / "gt.json"
    gtf.write_text(json.dumps(gt))
    for i, pred in enumerate(preds):
        pf = tmp_path / f"pred{i}.json"
        pf.write_text(json.dumps(pred))
        m, avg = ActivityNetDetection(str(gtf), str(pf)).evaluate()
        jm, javg = JaxActivityNetDetection(str(gtf), str(pf)).evaluate()
        np.testing.assert_array_equal(m, jm)
        assert avg == javg
        if i == 0:
            np.testing.assert_allclose(m, 1.0)
        if i == 1:
            assert m[0] == 1.0 and avg < 1.0
