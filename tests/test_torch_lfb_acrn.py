"""The long-term feature bank, the FBO and ACRN shared heads and the
detector configs of the PyTorch port against the JAX package.

* ``models/lfb.py``: the ram and mmap banks written by either package read
  by both, and the windows sampled from one seed equal to JAX's.
* ``FBOHead`` over ``FBONonLocal`` (pre-activated or not, a zero-initialised
  ``out_conv``), ``FBOAvg`` and ``FBOMax``, and ``ACRNHead`` in eval and
  train mode (batch statistics, the running ones they leave, gradients),
  with JAX's weights through ``params_from_jax``.
* The LFB flow: a detector with ``LFBInferHead`` run through
  ``run_detection_evaluation`` writes the bank of the fixture's train and
  val keyframes, which holds JAX's pooled roi features; ``LFB`` loads it in
  both packages; then two steps of ``train_model`` on the FBO detector
  against JAX's detection step on the same samples and windows.
* Every ``configs/detection/**`` config builds in the port, with the
  parameter names and shapes JAX's init gives the six distinct
  structures; and every config file that defines a model builds.

JAX's detector drops its shared head (``tests/test_torch_detection.py``,
``jax_shared_heads``): the references with one repair that check. Each
non-local layer drops at 0.2 in train mode, a rate its config cannot set;
the train-step comparison switches that dropout off in both packages
(``no_non_local_dropout``), and the port's draws are checked on their own.

Tolerances (CPU readings in brackets): FBO outputs 1e-6 of their largest
magnitude [4.3e-7], gradients 1e-6 of each tensor's largest element plus
1e-6 of the largest gradient [4.8e-7 of the largest]; ACRN eval and
train-mode outputs 1e-5 of the largest [4.0e-7, 5.8e-7], running
statistics 1e-5 [4.3e-8] and gradients 1e-4 [2.0e-6]; the bank's fp16 rows within one fp16 ulp of
JAX's pooled features plus 1e-6 of their largest magnitude (the
extractors' own gap); the train steps as
``tests/test_torch_detection.py``'s trajectory [losses 2.5e-7, tensors
1.4e-7, statistics 1.3e-6].
"""

import glob
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

import adapt_image_models_tpu.models.heads.fbo_head as jax_fbo
from adapt_image_models_tpu.config.config import Config as JaxConfig
from adapt_image_models_tpu.models.heads.acrn_head import ACRNHead as JaxACRNHead
from adapt_image_models_tpu.models.lfb import LFB as JaxLFB
from adapt_image_models_tpu.models.lfb import save_lfb as jax_save_lfb
from adapt_image_models_tpu.models.lfb import save_lfb_mmap as jax_save_lfb_mmap
from adapt_image_models_torch.apis import load_config, model_config, run_detection_evaluation
from adapt_image_models_torch.apis import train_model
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.heads import ACRNHead, FBOHead, NonLocalLayer
from adapt_image_models_torch.models.lfb import LFB, save_lfb, save_lfb_mmap

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_ava_data import ava_dataset_cfg, write_ava_tree
from test_torch_detection import (  # noqa: F401 (jax_shared_heads: a fixture)
    SLOWONLY, _load_into_init, detector_cfg, detector_inputs, detector_pair,
    jax_detection_run, jax_shared_heads, train_cfg,
)
from test_torch_resnet2d import _draw, _rel, _sum_rel, grads_close

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C = 16


def _bank(seed=0):
    rng = np.random.default_rng(seed)
    return {"vid_a": {900 + s: rng.normal(size=(3, C)).astype(np.float32) for s in range(10)},
            "vid_b": {900: rng.normal(size=(7, C)).astype(np.float32)}}


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_lfb_banks_and_sampling_match_jax(tmp_path, writer):
    """A bank saved by either package (npz for train, mmap rows for val)
    reads the same in both, on every backend; windows drawn from one seed,
    and from each bank's own seeded stream, equal JAX's: missing seconds
    zero, at most max_num_sampled_feat rows a second, without
    replacement."""
    ram, mmap = (save_lfb, save_lfb_mmap) if writer == "port" else (jax_save_lfb,
                                                                    jax_save_lfb_mmap)
    ram(str(tmp_path / "lfb_train.npz"), _bank(0))
    mmap(str(tmp_path / "lfb_val"), _bank(1))
    kw = dict(max_num_sampled_feat=2, window_size=4, lfb_channels=C, seed=3)
    for backend in ("auto", "ram"):
        modes = ("train", "val") if backend == "auto" else ("train",)
        lfb, jlfb = (cls(str(tmp_path), dataset_modes=modes, backend=backend, **kw)
                     for cls in (LFB, JaxLFB))
        assert len(lfb) == len(jlfb) == 2
        for vid, ts in (("vid_a", 902), ("vid_b", 901), ("vid_a", 909), ("vid_c", 900)):
            np.testing.assert_array_equal(
                lfb.sample_long_term_features(vid, ts, np.random.default_rng(5)),
                jlfb.sample_long_term_features(vid, ts, np.random.default_rng(5)))
            np.testing.assert_array_equal(lfb[f"{vid},{ts:04d}"], jlfb[f"{vid},{ts:04d}"])
    edge = lfb.sample_long_term_features("vid_b", 902)  # window [900, 904): 900 alone
    assert (np.abs(edge).sum(1) > 0).sum() == 2 and not np.allclose(edge[0], edge[1])
    mm = LFB(str(tmp_path), dataset_modes="val", backend="mmap", **kw)
    assert mm._mmap_modes and not mm.lfb
    with pytest.raises(ValueError):
        LFB(str(tmp_path / "missing"))


# ---- FBO and ACRN ----------------------------------------------------------------------

def _module_state(variables, root):
    """A bare module's variables as its port state dict (the FastRCNN
    root ``root`` of ``params_from_jax`` stripped)."""
    tree = {"params": {}, **{k: {root: v} for k, v in variables.items()}}
    prefix = {"shared_head_module": "shared_head."}[root]
    return {k[len(prefix):]: v for k, v in params_from_jax(tree).items()}


FBO_CASES = {
    "nl_pre": dict(type="non_local", st_feat_channels=24, lt_feat_channels=C, latent_channels=8,
                   num_non_local_layers=2, st_feat_dropout_ratio=0, lt_feat_dropout_ratio=0),
    "nl_post_zero": dict(type="non_local", st_feat_channels=24, lt_feat_channels=C,
                         latent_channels=8, num_non_local_layers=1, pre_activate=False,
                         zero_init_out_conv=True, st_feat_dropout_ratio=0,
                         lt_feat_dropout_ratio=0, num_st_feat=1, num_lt_feat=6),
    "avg": dict(type="avg"),
    "max": dict(type="max"),
}


@pytest.mark.parametrize("rank", [5, 6])
@pytest.mark.parametrize("name", list(FBO_CASES))
def test_fbo_head_matches_jax(name, rank):
    """FBOHead's fused (B, R, C + C_fbo) features from (B, R, O, O, C) and
    (B, R, T, O, O, C) roi features and a (B, R, L, C_lt) window, and the
    gradients of a weighted sum with respect to every weight, against
    JAX's (eval; no dropout is set)."""
    rng = np.random.default_rng(len(name) + rank)
    roi = rng.standard_normal((2, 3) + ((2,) if rank == 6 else ()) + (4, 4, 24))
    lt = rng.standard_normal((2, 3, 6, C))
    roi, lt = roi.astype(np.float32), lt.astype(np.float32)
    kw = dict(fbo_cfg=FBO_CASES[name], temporal_pool_type="max", spatial_pool_type="avg")
    jhead = jax_fbo.FBOHead(**kw)
    variables = _draw(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(roi),
                                     jnp.asarray(lt)), 1)
    head = FBOHead(**kw).eval()
    if name.startswith("nl"):
        head.load_state_dict(_module_state(variables, "shared_head_module"), strict=True)
    want = jhead.apply(variables, jnp.asarray(roi), jnp.asarray(lt))
    got = head(torch.tensor(roi), torch.tensor(lt))
    out_c = 24 + (8 if name.startswith("nl") else C)
    assert got.shape == want.shape == (2, 3, out_c)
    assert _rel(got, want) < 1e-6
    if name.startswith("nl"):
        cot = rng.standard_normal(got.shape).astype(np.float32)
        grads = jax.grad(lambda p: jnp.sum(jhead.apply({"params": p}, jnp.asarray(roi),
                                                       jnp.asarray(lt)) * cot))(variables["params"])
        (got * torch.tensor(cot)).sum().backward()
        # phi's bias has a zero gradient under the softmax: rounding noise
        # in both packages, held by the floor of the largest gradient
        grads_close(head, _module_state({"params": grads}, "shared_head_module"), 1e-6, 1e-6)


def test_fbo_dropout_draws_from_the_generator():
    """In train mode the non-local layers drop at their fixed 0.2 (and the
    st/lt features at their configured rates) from the given generator:
    one seed repeats, another differs, eval draws nothing."""
    head = FBOHead(fbo_cfg=dict(FBO_CASES["nl_pre"], st_feat_dropout_ratio=0.2))
    head.init_weights(torch.Generator().manual_seed(0))
    roi, lt = torch.randn(2, 3, 4, 4, 24), torch.randn(2, 3, 6, C)
    assert all(m.dropout_ratio == 0.2 for m in head.modules() if isinstance(m, NonLocalLayer))
    head.train()
    a, b, c = (head(roi, lt, torch.Generator().manual_seed(s)) for s in (1, 1, 2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    head.eval()
    assert torch.equal(head(roi, lt, torch.Generator().manual_seed(1)), head(roi, lt))


@pytest.mark.parametrize("train", [False, True])
def test_acrn_head_matches_jax(train):
    """ACRNHead (2 convs, stride 2) on (B, R, O, O, C_r) actors and a (B, T,
    H, W, C_f) scene: eval on the running statistics; train mode on the
    batch's, the running statistics it leaves and every gradient."""
    rng = np.random.default_rng(7)
    roi = rng.standard_normal((2, 3, 4, 4, 6)).astype(np.float32)
    feat = rng.standard_normal((2, 2, 6, 6, 10)).astype(np.float32)
    jhead = JaxACRNHead(in_channels=16, out_channels=8, num_convs=2, stride=2)
    variables = _draw(jax.eval_shape(jhead.init, jax.random.PRNGKey(0), jnp.asarray(roi),
                                     jnp.asarray(feat)), 2)
    head = ACRNHead(in_channels=16, out_channels=8, num_convs=2, stride=2)
    head.load_state_dict(_module_state(variables, "shared_head_module"), strict=True)
    cot = rng.standard_normal((2, 3, 2, 3, 3, 8)).astype(np.float32)

    def jloss(params):
        out, mut = jhead.apply({**variables, "params": params}, jnp.asarray(roi),
                               jnp.asarray(feat), deterministic=not train,
                               mutable=["batch_stats"])
        return jnp.sum(out * cot), (out, mut)

    (_, (want, mut)), grads = jax.value_and_grad(jloss, has_aux=True)(variables["params"])
    head.train(train)
    got = head(torch.tensor(roi), torch.tensor(feat))
    assert got.shape == want.shape == cot.shape
    assert _rel(got, want) < 1e-5
    (got * torch.tensor(cot)).sum().backward()
    grads_close(head, _module_state({"params": grads}, "shared_head_module"), 1e-4, 1e-6)
    stats = _module_state({"batch_stats": mut["batch_stats"]}, "shared_head_module")
    for k, v in stats.items():
        assert _rel(head.state_dict()[k], v.numpy()) < 1e-5, k


# ---- the LFB flow ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def ava_root(tmp_path_factory):
    return write_ava_tree(tmp_path_factory.mktemp("ava_lfb"))


@pytest.fixture
def no_non_local_dropout(monkeypatch):
    """The non-local layers' fixed 0.2 dropout off in both packages, so a
    train step is deterministic."""
    class JaxNonLocalNoDrop(jax_fbo.NonLocalLayer):
        dropout_ratio: float = 0.0

    monkeypatch.setattr(jax_fbo, "NonLocalLayer", JaxNonLocalNoDrop)
    monkeypatch.setattr(NonLocalLayer, "forward", _no_drop(NonLocalLayer.forward))


def _no_drop(forward):
    def wrapped(self, *args, **kw):
        self.dropout_ratio = 0.0
        return forward(self, *args, **kw)
    return wrapped


def test_lfb_infer_bank_then_fbo_train_steps_match_jax(ava_root, tmp_path, monkeypatch,
                                                       jax_shared_heads, no_non_local_dropout):
    """``LFBInferHead`` through ``run_detection_evaluation`` on the train and
    val keyframes (test mode: every proposal above the threshold) writes
    ``lfb_train.npz`` / ``lfb_val.npz``: a row per valid roi, JAX's
    max-pooled roi features in fp16. Both packages' ``LFB`` load them alike.
    Then ``train_model`` on the FBO detector (window 3 s x 2 features, a
    non-local layer) takes two steps, against JAX's detection step with
    the same windows (its bank's seeded stream) and weights."""
    lfb_dir = tmp_path / "lfb"
    x, rois, _ = detector_inputs()
    jmodel, variables, _ = detector_pair(detector_cfg(), x, rois)
    for mode in ("train", "val"):
        infer = detector_cfg(shared=dict(type="LFBInferHead", lfb_prefix_path=str(lfb_dir),
                                         dataset_mode=mode))
        cfg = dict(model=infer, data=dict(val=ava_dataset_cfg(ava_root, test_mode=True)))
        model = build_model(dict(infer))
        model.load_state_dict(params_from_jax(variables), strict=True)
        run_detection_evaluation(cfg, model, split="val")
    from adapt_image_models_tpu.apis.detection import make_det_prepare_fn
    from adapt_image_models_tpu.data.datasets import build_dataset as build_jax_dataset
    jds = build_jax_dataset(ava_dataset_cfg(ava_root, test_mode=True))
    bank = np.load(lfb_dir / "lfb_val.npz")
    # vidB,904 has no proposal: no roi, no row
    assert sorted(bank.files) == ["vidA,902", "vidB,903"]
    prepare = make_det_prepare_fn(jds.mean, jds.std)
    for idx, info in enumerate(jds.video_infos):
        s = jds.prepare_sample(idx, np.random.default_rng(0))
        roi_feat = jmodel.apply(variables, prepare(jnp.asarray(s["imgs"][None])),
                                jnp.asarray(s["rois"][None]),
                                method=lambda m, i, r: m.bbox_roi_extractor(m.extract_feat(i), r))
        want = np.asarray(roi_feat)[0][s["roi_weights"] > 0].max(axis=(1, 2)).astype(np.float16)
        key = f"{info['video_id']},{info['timestamp']}"
        if not len(want):
            continue
        want = want.astype(np.float32)
        np.testing.assert_allclose(bank[key].astype(np.float32), want, rtol=2 ** -10,
                                   atol=1e-6 * np.abs(want).max())
    lfb_cfg = dict(lfb_prefix_path=str(lfb_dir), max_num_sampled_feat=2, window_size=3,
                   lfb_channels=256, dataset_modes=("train", "val"))
    jl = JaxLFB(**lfb_cfg)
    np.testing.assert_array_equal(LFB(**lfb_cfg).sample_long_term_features("vidA", 902),
                                  jl.sample_long_term_features("vidA", 902))

    fbo = dict(type="FBOHead", lfb_cfg=lfb_cfg, fbo_cfg=dict(
        type="non_local", st_feat_channels=256, lt_feat_channels=256, latent_channels=16,
        num_non_local_layers=1, st_feat_dropout_ratio=0, lt_feat_dropout_ratio=0))
    cfg = train_cfg(ava_root, tmp_path / "fbo", model=detector_cfg(shared=fbo, in_channels=272),
                    total_epochs=1)
    x, rois, lt = detector_inputs(lt=(6, 256))
    _, fvars, _ = detector_pair(cfg["model"], x, rois, lt)
    assert "shared_head_module" in fvars["params"]
    want_losses, want, _ = jax_detection_run(cfg, fvars, 2, lfb=JaxLFB(**lfb_cfg))
    _load_into_init(monkeypatch, fvars)
    state, history = train_model(cfg, validate=False, seed=0, device="cpu")
    np.testing.assert_allclose([h["loss"] for h in history], want_losses, rtol=1e-5)
    got = state.model.state_dict()
    for k, v in want.items():
        assert _sum_rel(got[k], v) < (2e-5 if "running" in k else 1e-3), k


# ---- configs -----------------------------------------------------------------------------

DETECTION = sorted(glob.glob(os.path.join(ROOT, "configs/detection/**/*.py"), recursive=True))
# one config of each distinct detector structure
STRUCTURES = ["acrn/slowfast_acrn_kinetics_pretrained_r50_8x8x1_cosine_10e_ava_rgb.py",
              "ava/slowfast_context_kinetics_pretrained_r50_4x16x1_20e_ava_rgb.py",
              "ava/slowfast_kinetics_pretrained_r50_8x8x1_20e_ava_rgb.py",
              "ava/slowonly_nl_kinetics_pretrained_r50_4x16x1_10e_ava_rgb.py",
              "lfb/lfb_max_kinetics_pretrained_slowonly_r50_4x16x1_20e_ava_rgb.py",
              "lfb/lfb_nl_kinetics_pretrained_slowonly_r50_4x16x1_20e_ava_rgb.py"]


def _model_cfg(cfg):
    m = dict(cfg["model"])
    m.pop("train_cfg", None)
    m.pop("test_cfg", None)
    return m


def test_every_detection_config_builds():
    """The 20 detector recipes build in the port (on the meta device), each
    BBox head as wide as its config says, but for ``lfb_avg`` / ``lfb_max``,
    whose 2560 (inherited from ``lfb_nl``) is not the 2048 + 2048 of their
    fused feature, which the port takes, as flax infers it; each shared
    head the config's."""
    assert len(DETECTION) == 20
    for path in DETECTION:
        cfg = load_config(path)
        model = build_model(_model_cfg(cfg), device="meta")
        head = cfg["model"]["roi_head"]
        pooled = os.path.basename(path).startswith(("lfb_avg", "lfb_max"))
        assert model.bbox_head.fc_cls.in_features == (
            4096 if pooled else head["bbox_head"]["in_channels"]), path
        assert head["bbox_head"]["in_channels"] == (2560 if pooled else
                                                    model.bbox_head.fc_cls.in_features)
        shared = (head.get("shared_head") or {}).get("type")
        assert model.shared_kind == shared, path


@pytest.mark.parametrize("rel", STRUCTURES)
def test_detection_config_shapes_match_jax(rel, jax_shared_heads):
    """The parameter and statistic names and shapes of the port's detector
    against ``jax.eval_shape`` of JAX's init (its shared head built), which
    infers every width from the input: the configs' ``in_channels`` agree."""
    path = os.path.join(ROOT, "configs/detection", rel)
    cfg = load_config(path)
    jcfg = JaxConfig.fromfile(path).to_dict()
    from adapt_image_models_tpu.models import build_model as build_jax_model
    jmodel = build_jax_model(_model_cfg(jcfg))
    t = [s for s in cfg["data"]["val"]["pipeline"] if s["type"] == "SampleAVAFrames"][0]
    shared = cfg["model"]["roi_head"].get("shared_head") or {}
    lt = (jax.ShapeDtypeStruct((1, 6, shared["lfb_cfg"]["lfb_channels"]), jnp.float32)
          if shared.get("type") == "FBOHead" else None)
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 3, t["clip_len"], 64, 64), jnp.float32),
                          jax.ShapeDtypeStruct((1, 2, 4), jnp.float32), lt)
    want = {k: tuple(v.shape) for k, v in params_from_jax(
        jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), tree)).items()}
    got = {k: tuple(v.shape) for k, v in
           build_model(_model_cfg(cfg), device="meta").state_dict().items()}
    assert got == want


def test_every_config_with_a_model_builds():
    """Every config file under ``configs/`` that defines a model (the
    recipes and the ``_base_`` model files) builds in the port on the meta
    device: recognizers, localizers and detectors."""
    built = 0
    for path in sorted(glob.glob(os.path.join(ROOT, "configs/**/*.py"), recursive=True)):
        cfg = load_config(path)
        if "model" not in cfg:
            continue
        try:
            mcfg = model_config(cfg, "test")
        except (KeyError, TypeError, ValueError):  # a _base_ model file has no data;
            # a PoseC3D recipe's keypoint pipeline gives no frames
            mcfg = dict(cfg["model"])
        mcfg.pop("train_cfg", None)
        mcfg.pop("test_cfg", None)
        build_model(mcfg, device="meta")
        built += 1
    assert built == 233
