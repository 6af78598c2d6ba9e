"""The PoseC3D data stage of the PyTorch port against the JAX package:
every function of ``data/pose.py``, ``PoseSampleProcessor`` on the NTU-60
keypoint and limb recipes' pipelines and ``PoseDataset`` (pickled
annotations, ``valid_ratio`` / ``box_thr`` filtering and ``anno_inds``,
its samples through the loader, ``evaluate``), all bit-equal to JAX's
under the same numpy generator; the test pipelines' ``double=True``
rendering included. The recipes' pipelines run as shipped except their
length: ``clip_len`` 48 -> 8 and the test's 10 clips -> 2, which keeps the
heatmap volumes small (the shipped 10 x 48 x 64² x 17 x 2 persons is ~270
MB a broadcast). Both entry points refuse a PoseC3D recipe with JAX's
``ValueError``, as JAX's ``train_model`` does.
"""

import os
import pickle

import numpy as np
import pytest

import adapt_image_models_tpu.data.pose as jax_pose
from adapt_image_models_tpu.data.loader import VideoLoader as JaxVideoLoader
from adapt_image_models_tpu.data.pose_dataset import PoseDataset as JaxPoseDataset
import adapt_image_models_torch.data.pose as pose
from adapt_image_models_torch.apis import load_config, run_evaluation, train_model
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.pose_dataset import PoseDataset

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSEC3D = os.path.join(ROOT, "configs", "skeleton", "posec3d")
RECIPES = ("slowonly_r50_u48_240e_ntu60_xsub_keypoint.py",
           "slowonly_r50_u48_240e_ntu60_xsub_limb.py")
V = 17


def _equal(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    elif want is None:
        assert got is None
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        assert np.asarray(got).dtype == np.asarray(want).dtype


def _both(name, *args, seed=None, **kw):
    """The port's and JAX's ``name`` on the same arguments, each with a
    fresh generator of ``seed`` where given."""
    extra = {} if seed is None else {"rng": np.random.default_rng(seed)}
    got = getattr(pose, name)(*args, **kw, **extra)
    extra = {} if seed is None else {"rng": np.random.default_rng(seed)}
    want = getattr(jax_pose, name)(*args, **kw, **extra)
    _equal(got, want)
    return got


@pytest.mark.parametrize("num_frames", [5, 8, 12, 15, 47, 100])
def test_uniform_sample_frames_matches_jax(num_frames):
    """Train mode (short, mid and long videos) and test mode (1 and 3
    clips, its own seed), bit-equal."""
    for seed in range(3):
        _both("uniform_sample_frames", num_frames, 8, seed=seed)
    for clips in (1, 3):
        _both("uniform_sample_frames", num_frames, 8, clips, True)
        _both("uniform_sample_frames", num_frames, 8, clips, True, seed=7)


def _keypoints(seed, persons=2, frames=20, shape=(120, 160)):
    rng = np.random.default_rng(seed)
    kp = rng.uniform((20, 10), (shape[1] - 20, shape[0] - 10), (persons, frames, V, 2))
    kp[0, :, 3] = 0  # a missing keypoint
    return kp.astype(np.float32), rng.uniform(0.0, 1.0, (persons, frames, V)).astype(np.float32)


def test_geometry_matches_jax():
    """pose_decode, pose_compact (padding, threshold, hw_ratio,
    allow_imgpad), resize_kp, random_resized_crop_kp, center_crop_kp and
    flip_kp (missing keypoints stay at 0), bit-equal."""
    kp, score = _keypoints(0)
    inds = np.array([0, 3, 3, 19, 7])
    _both("pose_decode", kp, score, inds)
    _both("pose_decode", kp, None, inds)
    for kw in (dict(), dict(padding=0.0), dict(hw_ratio=(1.0, 1.0)),
               dict(hw_ratio=(1.5, 0.5), allow_imgpad=False), dict(threshold=500)):
        _both("pose_compact", kp, (120, 160), **kw)
    _both("resize_kp", kp, (120, 160), (64, 85))
    for seed in range(4):
        _both("random_resized_crop_kp", kp, (120, 160), (56, 56), seed=seed)
        _both("random_resized_crop_kp", kp, (30, 160), (56, 56), seed=seed,
              area_range=(0.9, 1.0))
    _both("center_crop_kp", kp, (120, 160), (64, 64))
    _both("flip_kp", kp, 160)
    _both("flip_kp", kp, 160, left_kp=(1, 3), right_kp=(2, 4))


@pytest.mark.parametrize("use_score", [True, False])
def test_heatmaps_match_jax(use_score):
    """keypoint_heatmaps, limb_heatmaps (a degenerate limb included) and
    generate_pose_target with and without double, keypoints and limbs."""
    kp, score = _keypoints(1, frames=4, shape=(32, 40))
    kp[1, :, 7] = kp[1, :, 5]  # the COCO limb (5, 7) of length 0
    values = score if use_score else np.ones(kp.shape[:-1], np.float32)
    _both("keypoint_heatmaps", kp, values, (32, 40))
    _both("limb_heatmaps", kp, values, (32, 40))
    for with_kp, with_limb in ((True, False), (False, True), (True, True)):
        for double in (False, True):
            got = _both("generate_pose_target", kp, score, (32, 40), 0.6, use_score, with_kp,
                        with_limb, double=double)
            assert got.shape == ((8 if double else 4), 32, 40,
                                 V * with_kp + len(pose.COCO_SKELETONS) * with_limb)
    with pytest.raises(ValueError):
        pose.generate_pose_target(kp, score, (32, 40), with_kp=False, with_limb=False)


def short_pipeline(pipeline):
    """The recipe's pipeline at clip_len 8 and at most 2 test clips."""
    out = []
    for step in pipeline:
        step = dict(step)
        if step["type"] == "UniformSampleFrames":
            step.update(clip_len=8, num_clips=min(step.get("num_clips", 1), 2))
        out.append(step)
    return out


def write_annotations(path, n, seed, kinetics=False):
    """A pickled list of ``n`` annotations of 2-3 persons over 6-29 frames
    of 1080 x 1920 (NTU style); ``kinetics``: with ``valid_frames``,
    ``valid@0.5`` / ``valid@0.7`` and per-person ``box_score``."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        t, persons = int(rng.integers(6, 30)), int(rng.integers(2, 4))
        centre = rng.uniform((500, 300), (1400, 800), (persons, 1, 1, 2))
        kp = centre + np.cumsum(rng.normal(0, 5, (persons, t, 1, 2)), axis=1) \
            + rng.normal(0, 60, (persons, 1, V, 2))
        item = dict(frame_dir=f"S{i:03d}", total_frames=t, label=i % 60,
                    img_shape=(1080, 1920), keypoint=kp.astype(np.float32),
                    keypoint_score=rng.uniform(0.2, 1.0, (persons, t, V)).astype(np.float32))
        if kinetics:
            item.update({"valid_frames": int(rng.integers(0, t + 1)),
                         "valid@0.5": int(rng.integers(0, t + 1)),
                         "valid@0.7": int(rng.integers(0, t + 1)),
                         "box_score": rng.uniform(0.4, 1.0, persons).tolist()})
        items.append(item)
    with open(path, "wb") as f:
        pickle.dump(items, f)
    return path


@pytest.fixture(scope="module")
def annotations(tmp_path_factory):
    root = tmp_path_factory.mktemp("pose")
    return (write_annotations(str(root / "ntu.pkl"), 6, seed=3),
            write_annotations(str(root / "kinetics.pkl"), 12, seed=4, kinetics=True))


@pytest.mark.parametrize("recipe", RECIPES)
@pytest.mark.parametrize("split", ["train", "val", "test"])
def test_pose_dataset_samples_match_jax(recipe, split, annotations):
    """PoseDataset of each recipe and split (the test split's double flip
    included): len, labels and every sample bit-equal to JAX's under the
    same generator; the loader's batches too."""
    cfg = load_config(os.path.join(POSEC3D, recipe))
    pipeline = short_pipeline(cfg["data"][split]["pipeline"])
    ds = build_dataset(dict(type="PoseDataset", ann_file=annotations[0], pipeline=pipeline))
    ref = JaxPoseDataset(annotations[0], pipeline=pipeline)
    assert len(ds) == len(ref) == 6
    np.testing.assert_array_equal(ds.labels(), ref.labels())
    for idx in range(len(ds)):
        got = ds.prepare_sample(idx, np.random.default_rng(idx))
        want = ref.prepare_sample(idx, np.random.default_rng(idx))
        _equal(got["imgs"], want["imgs"])
        assert got["label"] == want["label"]
    clips = 1 if split != "test" else 2 * 2  # the test split: 2 clips x double
    size = 56 if split == "train" else 64
    channels = V if recipe.endswith("keypoint.py") else len(pose.COCO_SKELETONS)
    assert got["imgs"].shape == (clips, 8, size, size, channels)
    port = VideoLoader(ds, None, 2, shuffle=True, seed=5, num_workers=2)
    jax_loader = JaxVideoLoader(ref, None, 2, shuffle=True, seed=5, num_workers=2)
    port.set_epoch(2)
    jax_loader.set_epoch(2)
    for a, b in zip(port, jax_loader):
        _equal(a["imgs"], b["imgs"])
        np.testing.assert_array_equal(a["label"], b["label"])


@pytest.mark.parametrize("box_thr", [None, "0.5", "0.7"])
def test_pose_dataset_filters_match_jax(box_thr, annotations):
    """valid_ratio with and without box_thr, and the persons a box_thr
    above 0.5 keeps (anno_inds): the same annotations and samples. Where
    box_thr keeps no person of a sample, JAX's heatmap max over the empty
    person axis raises; the port renders zeros, as the reference's loop
    over no person does (ROADMAP queue 3)."""
    pipeline = short_pipeline(load_config(os.path.join(POSEC3D, RECIPES[0]))
                              ["data"]["val"]["pipeline"])
    ds = PoseDataset(annotations[1], pipeline=pipeline, valid_ratio=0.4, box_thr=box_thr)
    ref = JaxPoseDataset(annotations[1], pipeline=pipeline, valid_ratio=0.4, box_thr=box_thr)
    assert 0 < len(ds) == len(ref) < 12
    assert [i["frame_dir"] for i in ds.video_infos] == [i["frame_dir"] for i in ref.video_infos]
    for a, b in zip(ds.video_infos, ref.video_infos):
        assert ("anno_inds" in a) == ("anno_inds" in b) == (box_thr == "0.7")
        if "anno_inds" in a:
            np.testing.assert_array_equal(a["anno_inds"], b["anno_inds"])
    empty = 0
    for idx in range(len(ds)):
        got = ds.prepare_sample(idx, np.random.default_rng(idx))["imgs"]
        if len(ds.video_infos[idx].get("anno_inds", [0])) == 0:
            empty += 1
            with pytest.raises(ValueError, match="zero-size array"):
                ref.prepare_sample(idx, np.random.default_rng(idx))
            assert got.shape == (1, 8, 64, 64, V) and not got.any()
            continue
        _equal(got, ref.prepare_sample(idx, np.random.default_rng(idx))["imgs"])
    assert empty == (1 if box_thr == "0.7" else 0)


def test_pose_dataset_evaluate_matches_jax(annotations):
    ds = PoseDataset(annotations[0], pipeline=None)
    ref = JaxPoseDataset(annotations[0], pipeline=None)
    scores = np.random.default_rng(0).random((len(ds), 60))
    metrics = ("top_k_accuracy", "mean_class_accuracy")
    assert ds.evaluate(scores, metrics=metrics) == ref.evaluate(scores, metrics=metrics)
    with pytest.raises(ValueError, match="without a pipeline"):
        ds.prepare_sample(0)


def test_entry_points_refuse_posec3d_as_jax(annotations, tmp_path):
    """train_model and run_evaluation refuse the recipe with JAX's
    ValueError, word for word: its pipeline compiler has no
    UniformSampleFrames (the pose stage runs through PoseDataset)."""
    from adapt_image_models_tpu.apis.train import train_model as jax_train_model
    cfg = load_config(os.path.join(POSEC3D, RECIPES[0]))
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = annotations[0]
    with pytest.raises(ValueError) as port_train:
        train_model(cfg, work_dir=str(tmp_path / "port"), device="cpu")
    with pytest.raises(ValueError) as port_eval:
        run_evaluation(cfg, device="cpu")
    with pytest.raises(ValueError) as jax_train:
        jax_train_model(cfg, work_dir=str(tmp_path / "jax"))
    assert str(port_train.value) == str(port_eval.value) == str(jax_train.value) \
        == "unsupported pipeline transform: UniformSampleFrames"
