"""ViT_CLIP_ZEROI2V in the PyTorch port against the JAX package: the STDHA
head shift, every block branch (linear adapters, one shared, the temporal
class token, its second adapter, ``reference_compat``, bottleneck adapters,
PatchShift) in eval at fp32 and bf16, a 4-step AdamW trajectory, the CLIP
and AIM converters, the eight shipped configs of the last ViT-family
backbones (ZeroI2V, res-tuning, ViT_ImageNet) built as shipped, and the
hmdb51 config through the entry points. It also holds the helpers that
``test_torch_restuning.py`` and ``test_torch_vit_imagenet.py`` share.

The same seeded numpy inputs and weights go through the JAX model and
through the port; the JAX tree converts with ``params_from_jax`` and loads
strictly. Toy geometry: resolution 48, patch 16 (3x3 patches, 10 tokens),
width 64 in 4 heads, 2 layers, T = 8 (the head-shift schedule is defined
for 8, 16 and 32 frames), bottleneck 16 for the linear adapters.

Tolerances (measured on a CPU in brackets), as ``tests/test_torch_dual.py``:
fp32 features 2e-5 relative + 2e-5 absolute and probabilities 1e-6 absolute
[7.2e-7 at 3.1, 3e-8]; bf16 5e-2 on features and 5e-4 on probabilities
[1.6e-2, one ulp at 3.1; 3.2e-5]; the trajectory's losses 1e-3 relative and
trainable parameters 1e-3 relative + 5e-6 absolute [losses 1.5e-7 relative,
parameters 2.1e-7 absolute]. The converters are exact.
"""

import copy
import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.convert.aim_import import load_aim_checkpoint_into_params
from adapt_image_models_tpu.convert.clip_import import load_clip_into_params
from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.models.backbones import zeroi2v as jax_zeroi2v
from adapt_image_models_tpu.parallel.partition import merge_params, partition_params
from adapt_image_models_torch.apis import (
    inference_recognizer, init_recognizer, load_config, run_evaluation, train_model,
)
from adapt_image_models_torch.convert import (
    load_aim_pretrained, load_clip_pretrained, params_from_jax,
)
from adapt_image_models_torch.convert.checkpoint import clip_visual_keys
from adapt_image_models_torch.core.checkpoint import CheckpointManager
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import TrainState, make_train_step
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.models.backbones import zeroi2v
from adapt_image_models_torch.ops import launch_counts, reset_launch_counts
from adapt_image_models_torch.parallel import freeze_params

from test_torch_flash import OPT, TOL, _jax_eval, _np  # the shared bounds and helpers
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RES, PATCH, D, HEADS, LAYERS, T, CLASSES = 48, 16, 64, 4, 2, 8, 5
TOY = dict(input_resolution=RES, patch_size=PATCH, width=D, layers=LAYERS, heads=HEADS,
           num_frames=T, drop_path_rate=0.0)
BRANCHES = {
    "linear": dict(linear_adapter=True, bottleneck=16),
    "linear_shared": dict(linear_adapter=True, share_adapter=True, bottleneck=16),
    "bottleneck": dict(linear_adapter=False),
    "linear_tcls": dict(linear_adapter=True, bottleneck=16, with_t_cls_token=True),
    "psm_tcls": dict(shift_type="psm", linear_adapter=False, with_t_cls_token=True),
    "tadapter2": dict(linear_adapter=False, with_t_cls_token=True, num_tadapter=2),
    "reference_compat": dict(linear_adapter=True, bottleneck=16, reference_compat=True),
}


# ---------------------------------------------------------------------------
# helpers of the three files


def randomize(params, seed):
    """Seeded values where JAX initialises constants: every adapter's
    ``D_fc2``, the temporal embedding, the LayerNorms' affines (CLIP's
    ``ln_*`` and the timm ``norm*/ln``)."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        leaf = np.asarray(leaf)
        if "D_fc2" in name or "temporal_embedding" in name:
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        norm = re.search(r"(^|/)(ln_\w+|norm\d|ln)/(scale|bias)$", name)
        if norm and norm.group(3) == "scale":
            return (1 + 0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        if norm:
            return (0.1 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, params)


def recognizer(backbone, dtype="float32", width=D):
    return dict(type="Recognizer3D", backbone=dict(backbone, compute_dtype=dtype),
                cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=width,
                              dropout_ratio=0.0),
                test_cfg=dict(average_clips="prob"))


def seeded_jax_params(cfg, frames, res, seed=0):
    """A JAX recognizer's params from ``seed``, constants randomized."""
    variables = jax.jit(build_jax_model(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 3, frames, res, res)))
    return randomize(variables["params"], seed + 1)


def port_from_jax(cfg, params):
    model = build_model(cfg)
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def eval_matches_jax(cfg, params, frames, res, dtype, port_cfg=None):
    """extract_feat and forward_test over 3 views of 2 clips against the JAX
    model on the same weights, within ``TOL``; nothing launches.
    ``port_cfg`` builds the port's model where it differs from ``cfg``."""
    imgs = np.random.default_rng(2).standard_normal(
        (2, 3, 3, frames, res, res)).astype(np.float32)
    want_feat, want_prob = _jax_eval(build_jax_model(cfg), params, jnp.asarray(imgs))
    model = port_from_jax(port_cfg or cfg, params).eval()
    reset_launch_counts()
    with torch.no_grad():
        got_feat = model.extract_feat(torch.from_numpy(imgs)).float().numpy()
        got_prob = model.forward_test(torch.from_numpy(imgs)).numpy()
    assert not any(launch_counts().values())
    rtol, atol, prob_tol = TOL[dtype]
    np.testing.assert_allclose(got_feat, _np(want_feat), rtol=rtol, atol=atol)
    np.testing.assert_allclose(got_prob, np.asarray(want_prob), rtol=0, atol=prob_tol)


def trajectory_matches_jax(cfg, params, frames, res, steps=4, batch=2, opt=OPT,
                           grad_clip=None, port_cfg=None):
    """``steps`` AdamW steps (drop path off so that no draw differs) of the
    optimizer ``opt`` with ``grad_clip``: the port's train step after the
    AIM freeze against JAX ``make_train_step`` after ``partition_params``;
    the same tensors train on both sides. ``port_cfg`` builds the port's
    model where it differs from ``cfg``."""
    trainable, _ = partition_params(params)
    tx = jax_build_optimizer(opt, trainable, schedule=3e-4, grad_clip=grad_clip)
    state = create_train_state(params, tx)
    rng = np.random.default_rng(3)
    batches = [(rng.standard_normal((batch, 1, 3, frames, res, res)).astype(np.float32),
                np.arange(batch) % CLASSES + k % 2) for k in range(steps)]
    step = jax.jit(jax_make_train_step(build_jax_model(cfg), tx))
    losses_j = []
    for imgs, labels in batches:
        state, metrics = step(state, {"imgs": jnp.asarray(imgs), "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
        losses_j.append(float(metrics["loss"]))

    model = port_from_jax(port_cfg or cfg, params)
    freeze_params(model)
    opt = build_optimizer(opt, model, 3e-4, grad_clip=grad_clip)
    tstate = TrainState(model, opt)
    train_step = make_train_step(model, opt)
    losses_t = [float(train_step(tstate, {"imgs": torch.from_numpy(imgs), "label": labels},
                                 0)["loss"]) for imgs, labels in batches]
    np.testing.assert_allclose(losses_t, losses_j, rtol=1e-3)
    # the first batch's loss again, after the steps: below where it began
    with torch.no_grad():
        again = float(torch.nn.functional.cross_entropy(
            model(torch.from_numpy(batches[0][0])), torch.from_numpy(batches[0][1])))
    assert again < losses_t[0], (again, losses_t)
    got = dict(model.named_parameters())
    want = params_from_jax(state.trainable)
    assert set(want) == {n for n, p in got.items() if p.requires_grad}
    for name, w in want.items():
        np.testing.assert_allclose(got[name].detach().numpy(), w.numpy(),
                                   rtol=1e-3, atol=5e-6, err_msg=name)
    return want


def gradients_match_jax(cfg, params, frames, res, port_cfg=None):
    """The gradients of the cross-entropy of 2 clips (eval mode: no draw)
    with respect to the trainable tensors after the AIM freeze against
    ``jax.grad`` over JAX's trainable tree (``partition_params``), the same
    tensors on both sides. ``port_cfg`` builds the port's model where it
    differs from ``cfg``. Returns (JAX's, the port's) gradients by name."""
    # jnp leaves: a frozen numpy table indexed by a traced index would not trace
    trainable, frozen = partition_params(jax.tree_util.tree_map(jnp.asarray, params))
    rng = np.random.default_rng(4)
    imgs = rng.standard_normal((2, 3, frames, res, res)).astype(np.float32)
    labels = np.arange(2) % CLASSES
    jmodel = build_jax_model(cfg)

    def loss(tree):
        logits = jmodel.apply({"params": merge_params(tree, frozen)}, jnp.asarray(imgs))
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(labels)[:, None], 1))

    want = params_from_jax(jax.jit(jax.grad(loss))(trainable))
    model = port_from_jax(port_cfg or cfg, params)
    freeze_params(model)
    logits = model.eval()(torch.from_numpy(imgs))
    torch.nn.functional.cross_entropy(logits, torch.from_numpy(labels)).backward()
    got = {n: p.grad for n, p in model.named_parameters() if p.requires_grad}
    assert set(got) == set(want)
    return want, got


def every_adapter_gets_a_gradient(cfg, frames, res):
    """One train-mode backward from the port's own seeded init, drop path
    on, after the AIM freeze: every trainable tensor gets a gradient and
    no frozen one; every adapter's ``D_fc1`` weight a nonzero one."""
    cfg = copy.deepcopy(cfg)
    key = "drop_path_rate"
    cfg["backbone"][key] = 0.2
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    with torch.no_grad():
        g = torch.Generator().manual_seed(1)
        for name, p in model.named_parameters():
            if ".D_fc2." in name:
                p.copy_(0.05 * torch.randn(p.shape, generator=g))
    trainable = set(freeze_params(model))
    model.train()
    logits = model(torch.randn(2, 3, frames, res, res),
                   generator=torch.Generator().manual_seed(2))
    logits.sum().backward()
    for name, p in model.named_parameters():
        assert (p.grad is not None) == (name in trainable), name
        if ".D_fc1.weight" in name:
            assert p.grad.abs().sum() > 0, name
    return trainable


def clip_state_dict(model, blocks, seed):
    """A CLIP visual state dict of ``blocks`` blocks at the model's width,
    seeded, with ``proj``."""
    g = torch.Generator().manual_seed(seed)
    own = model.state_dict()
    sd = {}
    for k in clip_visual_keys(blocks):
        shape = own["backbone." + re.sub(r"resblocks\.\d+\.", "resblocks.0.", k)].shape
        sd[k] = torch.randn(*shape, generator=g) * 0.1
    sd["proj"] = torch.randn(model.backbone.width, 16, generator=g)
    return sd


def same_as_jax(model, params):
    """The port model's state equals the JAX tree's bit for bit."""
    want = params_from_jax(params)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(got[k], v, rtol=0, atol=0, msg=k)


def clip_pretrained_matches_jax(tmp_path, cfg, params):
    """load_clip_pretrained against load_clip_into_params: CLIP's visual
    weights of 3 blocks (the model's 2 are read) into backbone.*, ``proj``
    dropped, everything else at its initialisation; from a file and from a
    mapping."""
    sd = clip_state_dict(build_model(cfg), 3, 20)
    want = load_clip_into_params(params, sd, LAYERS)
    path = tmp_path / "clip.pt"
    torch.save(sd, path)
    for source in (str(path), sd):
        same_as_jax(load_clip_pretrained(port_from_jax(cfg, params), source), want)
    before, after = params_from_jax(params), params_from_jax(want)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    assert moved == {"backbone." + k for k in clip_visual_keys(LAYERS)}


def config_runs_through_the_entry_points(tmp_path, name, directory="vit", **backbone):
    """``name`` (under ``configs/recognition/<directory>``) as shipped but
    for ``backbone``'s toy widths, on the CPU:
    init_recognizer, inference_recognizer and run_evaluation through its
    test pipeline, then train_model for one step through its train pipeline
    and the AIM freeze; nothing launches, the frozen tensors stay as they
    were bit for bit and some trainable one moves; the checkpoint reloads
    through init_recognizer bit for bit."""
    cfg = load_config(os.path.join(ROOT, "configs", "recognition", directory, name))
    bb = cfg["model"]["backbone"]
    bb.update(backbone)
    # the backbone's own width key; a Swin doubles it at each patch merging
    width = next(bb[k] for k in ("width", "embed_dim", "embed_dims") if k in bb)
    cfg["model"]["cls_head"]["in_channels"] = width * 2 ** (len(bb.get("depths", (1,))) - 1)
    classes = cfg["model"]["cls_head"]["num_classes"]
    ann = tmp_path / "ann.txt"
    ann.write_text("synthetic://0 1\nsynthetic://1 3\n")
    for split in ("train", "val", "test"):
        cfg["data"][split]["ann_file"] = str(ann)
    model = init_recognizer(cfg, device="cpu", seed=0)
    reset_launch_counts()
    top5 = inference_recognizer(model, cfg, "synthetic://0")
    assert len(top5) == 5 and all(0 <= c < classes and 0 <= p <= 1 for c, p in top5)
    _, scores, _ = run_evaluation(cfg, model=model, batch_size=1, num_workers=1,
                                  return_scores=True)
    assert scores.shape == (2, classes) and np.allclose(scores.sum(1), 1, atol=1e-5)
    tcfg = copy.deepcopy(cfg)
    tcfg["data"].update(videos_per_gpu=1, workers_per_gpu=1)
    tcfg.update(total_epochs=1, checkpoint_config=dict(interval=1), log_config=dict(interval=1))
    initial = model.state_dict()
    work = str(tmp_path / "work")
    state, history = train_model(tcfg, work_dir=work, seed=0, max_steps=1, validate=False,
                                 device="cpu")
    assert not any(launch_counts().values())
    assert state.step == 1 and all(np.isfinite(h["loss"]) for h in history)
    trained = state.model.state_dict()
    trainable = {n for n, p in state.model.named_parameters() if p.requires_grad}
    assert all(torch.equal(initial[n], trained[n]) for n in initial if n not in trainable)
    assert any(not torch.equal(initial[n], trained[n]) for n in trainable)
    reloaded = init_recognizer(tcfg, checkpoint=CheckpointManager(work).path(1), device="cpu")
    for k, v in reloaded.state_dict().items():
        torch.testing.assert_close(v, trained[k], rtol=0, atol=0, msg=k)
    return state.model


# ---------------------------------------------------------------------------
# the head shift


@pytest.mark.parametrize("frames,heads", [(8, 2), (16, 4), (32, 5)])
def test_head_shift_matches_jax(frames, heads):
    """head_shift and its inverse equal JAX's exactly at each scheduled T
    (the fewest heads the schedule reaches); another T is refused."""
    x = np.random.default_rng(0).standard_normal((2 * frames, heads, 3, 4)).astype(np.float32)
    for inv in (False, True):
        np.testing.assert_array_equal(
            zeroi2v.head_shift(torch.from_numpy(x), frames, inv).numpy(),
            np.asarray(jax_zeroi2v.head_shift(jnp.asarray(x), frames, inv)))
    back = zeroi2v.head_shift(zeroi2v.head_shift(torch.from_numpy(x), frames), frames, True)
    np.testing.assert_array_equal(back.numpy(), x)
    with pytest.raises(ValueError):
        zeroi2v.head_shift(torch.from_numpy(x[:12]), 12)


# ---------------------------------------------------------------------------
# the toy model


_PARAMS = {}


def _cfg(branch, dtype="float32"):
    return recognizer(dict(TOY, type="ViT_CLIP_ZEROI2V", **BRANCHES[branch]), dtype)


def _jax_params(branch):
    """Seeded JAX params of the branch, built once per module."""
    if branch not in _PARAMS:
        _PARAMS[branch] = seeded_jax_params(_cfg(branch), T, RES)
    return _PARAMS[branch]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_zeroi2v_blocks_carry_the_jax_names(branch):
    """Each branch builds exactly the JAX block's parameters under their
    names (CLIP's ``attn.in_proj_weight``/``out_proj`` for the frozen
    attention), and the freeze leaves trainable what JAX's partition
    does."""
    params = _jax_params(branch)
    model = build_model(_cfg(branch))
    assert set(model.state_dict()) == set(params_from_jax(params))
    trainable = set(freeze_params(model))
    assert trainable == set(params_from_jax(partition_params(params)[0]))


EVAL_CASES = [(branch, dtype) for branch in BRANCHES for dtype in ("float32", "bfloat16")]


@pytest.mark.parametrize("branch,dtype", EVAL_CASES)
def test_zeroi2v_model_matches_jax_eval(branch, dtype):
    """Every branch's features and probabilities against JAX's."""
    eval_matches_jax(_cfg(branch, dtype), _jax_params(branch), T, RES, dtype)


def test_zeroi2v_trajectory_matches_jax():
    """4 AdamW steps of the branch with the most adapters (linear q/k/v,
    output and MLP adapters and the temporal class token's T_Adapter)."""
    want = trajectory_matches_jax(_cfg("linear_tcls"), _jax_params("linear_tcls"), T, RES)
    assert any(".Attn_Adapter_q." in n for n in want) and any(".T_Adapter." in n for n in want)


@pytest.mark.parametrize("branch", ["linear_shared", "psm_tcls", "tadapter2"])
def test_zeroi2v_train_mode_reaches_every_adapter(branch):
    every_adapter_gets_a_gradient(_cfg(branch), T, RES)


def test_zeroi2v_refusals():
    """An unscheduled T and an unknown shift type raise ValueError."""
    model = build_model(recognizer(dict(TOY, type="ViT_CLIP_ZEROI2V", num_frames=12)))
    with pytest.raises(ValueError):
        model.extract_feat(torch.zeros(1, 3, 12, RES, RES))
    with pytest.raises(ValueError):
        build_model(recognizer(dict(TOY, type="ViT_CLIP_ZEROI2V", shift_type="tsm")))


# ---------------------------------------------------------------------------
# converters


@pytest.mark.parametrize("branch", ["linear", "tadapter2"])
def test_zeroi2v_clip_pretrained_matches_jax(tmp_path, branch):
    clip_pretrained_matches_jax(tmp_path, _cfg(branch), _jax_params(branch))


def test_zeroi2v_load_from_matches_jax():
    """load_aim_pretrained of a released-style ZeroI2V checkpoint with
    linear adapters (another seed's model, CLIP's ``proj`` beside) against
    load_aim_checkpoint_into_params(strict=False): the CLIP core, the
    temporal embedding, every linear adapter and fc_cls move, bit for bit."""
    init = _jax_params("linear")
    sd = params_from_jax(seeded_jax_params(_cfg("linear"), T, RES, seed=10))
    sd["backbone.proj"] = torch.zeros(D, 8)
    ckpt = {"meta": {"epoch": 30}, "state_dict": sd}
    want = load_aim_checkpoint_into_params(init, ckpt, strict=False)
    same_as_jax(load_aim_pretrained(port_from_jax(_cfg("linear"), init), ckpt), want)
    before, after = params_from_jax(init), params_from_jax(want)
    moved = {k for k in before if not torch.equal(before[k], after[k])}
    for name in ("Attn_Adapter_q", "Attn_Adapter_out", "MLP_Adapter_in", "MLP_Adapter_out"):
        assert f"backbone.transformer.resblocks.1.{name}.D_fc2.weight" in moved
    assert {"cls_head.fc_cls.weight", "backbone.temporal_embedding"} <= moved


# ---------------------------------------------------------------------------
# the shipped configs


SHIPPED = ["flash_attn/vitclip_flash_restuning_base_hmdb51.py",
           "flash_attn/vitclip_flash_restuning_base_diving48.py",
           "zeroI2V/vitclip_zeroI2V_base_hmdb51.py",
           "zeroI2V/vitclip_zeroI2V_base_diving48.py",
           "zeroI2V/vitclip_zeroI2V_base_sthv2.py",
           "zeroI2V/zeroi2v_base_k400.py",
           "vit_imagenet_k400.py", "vit_imagenet_ssv2.py"]


def _shapes(tree):
    """The port's keys and shapes of a JAX param tree of shape structs."""
    zeros = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), tree)
    return {k: tuple(v.shape) for k, v in params_from_jax(zeros).items()}


@pytest.mark.parametrize("name", SHIPPED)
def test_shipped_configs_build(name):
    """Each config builds as shipped through load_config + build_model (on
    the meta device: ViT-B/16 at full width), with the JAX model's keys and
    shapes (``jax.eval_shape`` of its init) and its frames."""
    cfg = load_config(os.path.join(ROOT, "configs", "recognition", "vit", name))
    bb = cfg["model"]["backbone"]
    model = build_model(cfg["model"], device="meta")
    frames = bb["num_frames"]
    res = bb.get("input_resolution", bb.get("img_size"))
    jmodel = build_jax_model(cfg["model"])
    tree = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                          jax.ShapeDtypeStruct((1, 3, frames, res, res), jnp.float32))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == _shapes(tree["params"])
    assert sum(int(np.prod(s)) for s in got.values()) > 85_000_000


def test_zeroi2v_config_runs_through_the_entry_points(tmp_path):
    """vitclip_zeroI2V_base_hmdb51.py (32 frames, bottleneck adapters, the
    temporal class token) at 2 layers of width 128 in 8 heads (T = 32 needs
    5)."""
    model = config_runs_through_the_entry_points(
        tmp_path, "zeroI2V/vitclip_zeroI2V_base_hmdb51.py", width=128, heads=8, layers=2)
    assert isinstance(model.backbone, zeroi2v.ViT_CLIP_ZEROI2V)
    assert model.backbone.transformer.resblocks[0].with_t_cls_token
