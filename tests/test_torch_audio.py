"""Audio recognition in the PyTorch port against the JAX package: the host
stage (``data/audio.py``: ``load_wav``, the mel filterbank, the log-mel
spectrogram, ``AudioSampleProcessor``, and the ``AudioDataset``,
``AudioFeatureDataset`` and ``AudioVisualDataset`` samples) bit for bit on
``.wav`` files, ``.npy`` features and JPEG frames the test writes, with the
same seeds; and the models: ``ConvAudio`` (``concat`` and ``sum``),
``ResNetAudio``, and ``AudioRecognizer`` with ``AudioTSNHead`` over
``ResNetAudio`` and over the 2D ``ResNet`` of one input channel.

Seeded JAX variables (``test_torch_resnet2d._draw``) convert with
``params_from_jax``. Tolerances (CPU readings in brackets): the host stage
``np.array_equal``; eval outputs 1e-5 of the largest magnitude [1.0e-6].
"""

import os
import wave

import cv2
import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.data import audio as jax_audio
from adapt_image_models_tpu.data.datasets import build_dataset as jax_build_dataset
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.common import ConvAudio as JaxConvAudio
from adapt_image_models_torch.apis import load_config
from adapt_image_models_torch.apis.inference import sample_shape
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.data import audio
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.data.pipeline import build_sample_processor
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.common import ConvAudio

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _draw, _rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIO = os.path.join(ROOT, "configs", "recognition", "audio")
WAV_RECIPE = os.path.join(AUDIO, "tsn_r50_64x1x1_100e_kinetics400_audio.py")
FEATURE_RECIPE = os.path.join(AUDIO, "resnet_audio_r50_64x1x1_100e_kinetics400_audio.py")
CLASSES = 5


def write_wav(path, seconds, rate=16000, channels=1, width=2, seed=0):
    rng = np.random.default_rng(seed)
    n = int(seconds * rate)
    t = np.arange(n) / rate
    tone = 0.3 * np.sin(2 * np.pi * (220 + 50 * seed) * t) + 0.05 * rng.standard_normal(n)
    pcm = np.repeat(tone[:, None], channels, 1)
    if width == 2:
        raw = (np.clip(pcm, -1, 1) * 32767).astype("<i2").tobytes()
    else:
        raw = (np.clip(pcm, -1, 1) * 127 + 128).astype(np.uint8).tobytes()
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(rate)
        w.writeframes(raw)


@pytest.fixture(scope="module")
def media(tmp_path_factory):
    """Three wav files (2.5 s mono 16-bit, 1 s stereo 16-bit, 0.5 s mono
    8-bit), three .npy log-mel feature files of 200, 90 and 700 rows, and
    a frame directory per feature file, with annotation lines for each
    dataset type."""
    root = tmp_path_factory.mktemp("audio")
    specs = [(2.5, 1, 2), (1.0, 2, 2), (0.5, 1, 1)]
    for i, (sec, ch, width) in enumerate(specs):
        write_wav(root / f"a{i}.wav", sec, channels=ch, width=width, seed=i)
    rng = np.random.default_rng(5)
    for i, rows in enumerate((200, 90, 700)):
        np.save(root / f"f{i}.npy", rng.standard_normal((rows, 80)).astype(np.float32))
        frames = root / "frames" / f"f{i}"
        frames.mkdir(parents=True)
        for k in range(1, 9):
            img = rng.integers(0, 256, (36, 44, 3), dtype=np.uint8)
            cv2.imwrite(str(frames / f"img_{k:05}.jpg"), img)
    (root / "wav.txt").write_text("a0.wav 75 1\na1.wav 30 3\na2.wav 300 4\n")
    (root / "feat.txt").write_text("f0 300 2\nf1.npy 30 0\nf2 64 4\nmissing 100 1\n")
    (root / "av.txt").write_text("f0 8 2\nf1 8 0\nf2 8 4\n")
    return root


def test_wav_and_mel_are_jax(media):
    """load_wav (16-bit mono and stereo, 8-bit), the mel filterbank and the
    log-mel spectrogram (padded and cut) bit for bit."""
    for i in range(3):
        got, want = audio.load_wav(str(media / f"a{i}.wav")), jax_audio.load_wav(
            str(media / f"a{i}.wav"))
        assert got[1] == want[1] and np.array_equal(got[0], want[0])
    np.testing.assert_array_equal(audio._mel_filterbank(16000, 400, 80),
                                  jax_audio._mel_filterbank(16000, 400, 80))
    y = audio.load_wav(str(media / "a0.wav"))[0]
    for kw in (dict(), dict(fixed_frames=64), dict(fixed_frames=400, n_mels=40, log=False)):
        got = audio.melspectrogram(y, **kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_audio.melspectrogram(y, **kw))
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(audio.amplify(y, rng_a, 1.5), jax_audio.amplify(y, rng_b, 1.5))


@pytest.mark.parametrize("recipe,split", [(WAV_RECIPE, "train"), (WAV_RECIPE, "test"),
                                          (FEATURE_RECIPE, "train"),
                                          (FEATURE_RECIPE, "test")],
                         ids=["wav-train", "wav-test", "feature-train", "feature-test"])
def test_dataset_samples_are_jax(media, recipe, split):
    """The recipe's dataset over the written files through the port's
    loader, whose per-sample seed JAX's ``prepare_sample`` gets: the (S, 1,
    T, F) float32 segments and labels of both packages, bit for bit (the
    train pipeline's window draws and AudioAmplify gain too; a missing
    feature file gives the dummy), and the sample's shape is the recipe's
    init sample (batches of 2 and of 1 give the same samples)."""
    cfg = load_config(recipe)
    ds_cfg = dict(cfg["data"][split], data_prefix=str(media),
                  ann_file=str(media / ("wav.txt" if "AudioDataset" == cfg["data"][split]["type"]
                                        else "feat.txt")))
    port, jax_ds = build_dataset(dict(ds_cfg)), jax_build_dataset(dict(ds_cfg))
    assert len(port) == len(jax_ds) and np.array_equal(port.labels(), jax_ds.labels())
    pipeline = ds_cfg["pipeline"]
    assert isinstance(build_sample_processor(pipeline), audio.AudioSampleProcessor)
    batches = [VideoLoader(port, pipeline, batch_size=size, shuffle=False, seed=7,
                           num_workers=2) for size in (1, 2)]
    pairs = list(iter(batches[1]))
    for idx, batch in enumerate(batches[0]):
        want = jax_ds.prepare_sample(idx, np.random.default_rng((7, 0, idx)))
        assert batch["label"][0] == want["label"]
        assert batch["imgs"].dtype == np.float32
        np.testing.assert_array_equal(batch["imgs"][0], want["imgs"])
        if idx < 2 * len(pairs):
            np.testing.assert_array_equal(pairs[idx // 2]["imgs"][idx % 2], want["imgs"])
        assert batch["imgs"].shape[:4] == sample_shape(pipeline)[:4]


def test_audio_visual_samples_are_jax(media):
    """AudioVisualDataset: rawframe clips and the audio features of one
    sample, from one rng state, as JAX's."""
    pipeline = [dict(type="SampleFrames", clip_len=2, frame_interval=1, num_clips=2),
                dict(type="RawFrameDecode"), dict(type="Resize", scale=(-1, 32)),
                dict(type="CenterCrop", crop_size=32),
                dict(type="LoadAudioFeature"), dict(type="AudioFeatureSelector",
                                                    fixed_length=16),
                dict(type="FormatAudioShape", input_format="NCTF"),
                dict(type="Normalize", mean=[0, 0, 0], std=[1, 1, 1]),
                dict(type="FormatShape", input_format="NCTHW")]
    cfg = dict(type="AudioVisualDataset", ann_file=str(media / "av.txt"), pipeline=pipeline,
               data_prefix=str(media / "frames"), audio_prefix=str(media))
    port, jax_ds = build_dataset(dict(cfg)), jax_build_dataset(dict(cfg))
    for idx in range(len(port)):
        got = port.prepare_sample(idx, np.random.default_rng(idx))
        want = jax_ds.prepare_sample(idx, np.random.default_rng(idx))
        assert got["label"] == want["label"]
        for key in ("imgs", "audios"):
            np.testing.assert_array_equal(got[key], want[key])
        assert got["audios"].shape == (2, 1, 16, 80)


@pytest.mark.parametrize("op", ["concat", "sum"])
def test_conv_audio_matches_jax(op):
    x = np.random.default_rng(1).standard_normal((3, 1, 20, 16)).astype(np.float32)
    jmod = JaxConvAudio(8, 5, op=op)
    xj = jnp.asarray(np.moveaxis(x, 1, -1))
    tree = jax.eval_shape(jmod.init, jax.random.PRNGKey(0), xj)
    variables = _draw(tree, 2)
    sd = params_from_jax({k: {"backbone_module": v} for k, v in variables.items()})
    port = ConvAudio(1, 8, 5, op=op).eval()
    port.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
    with torch.no_grad():
        got = port(torch.tensor(x))
    want = np.moveaxis(np.asarray(jmod.apply(variables, xj)), -1, 1)
    assert got.shape == want.shape and _rel(got, want) < 1e-5
    with pytest.raises(ValueError):
        ConvAudio(1, 8, op="max")


MODELS = {
    "resnet_audio": dict(type="ResNetAudio", depth=18, base_channels=8),
    "resnet_audio_50": dict(type="ResNetAudio", depth=50, base_channels=8),
    "resnet_1ch": dict(type="ResNet", depth=18, in_channels=1, stage_blocks=(1, 1, 1, 1),
                       base_channels=16),
}
CHANNELS = {"resnet_audio": 64, "resnet_audio_50": 256, "resnet_1ch": 128}


@pytest.mark.parametrize("name", list(MODELS))
def test_audio_recognizer_matches_jax(name):
    """AudioRecognizer over (B, S, 1, frames, mels) spectrograms: the eval
    logits, forward_test's probabilities and the (B, S, D) segment
    features; ResNetAudio's ``norm_eval`` keeps its BatchNorms' statistics
    in a train-mode forward."""
    cfg = dict(type="AudioRecognizer", backbone=MODELS[name],
               cls_head=dict(type="AudioTSNHead", num_classes=CLASSES,
                             in_channels=CHANNELS[name], dropout_ratio=0.0))
    shape = (2, 3, 1, 48, 40)
    jmodel = build_jax_model(cfg, test_cfg=dict(average_clips="prob"))
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct(shape, jnp.float32))
    variables = _draw(tree, 4)
    model = build_model(cfg, test_cfg=dict(average_clips="prob"))
    model.load_state_dict(params_from_jax(variables), strict=True)
    model.eval()
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.tensor(x)
    with torch.no_grad():
        assert _rel(model(xt), jax.jit(jmodel.apply)(variables, xj)) < 1e-5
        probs = model.forward_test(xt)
        feats = model.backbone(xt.reshape(6, 1, 48, 40)).reshape(2, 3, -1)
        assert torch.equal(model.extract_feat(xt), feats)
    want = jmodel.apply(variables, xj, method=jmodel.forward_test)
    assert float((probs - torch.tensor(np.asarray(want))).abs().max()) < 1e-6
    if name == "resnet_audio":
        cfg["backbone"] = dict(MODELS[name], norm_eval=True)
        frozen = build_model(cfg).train()
        frozen.load_state_dict(model.state_dict())
        with torch.no_grad():
            frozen(xt)
        assert all(torch.equal(v, model.state_dict()[k])
                   for k, v in frozen.state_dict().items())
