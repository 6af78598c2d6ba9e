"""Data parallelism of the port on the CPU: two gloo ranks against one
process and against the JAX package's train step.

* (i) the port's ``VideoLoader._epoch_indices`` equals the JAX package's
  (``data/loader.py:101-119``) for every shard;
* (ii) the toy AIM of ``tests/test_runtime/test_two_process_distributed.py``
  (32², patch 16, width 64, 4 heads, 2 layers, T 4, 5 classes, global batch
  4, 2 steps, fp32, drop path 0): two ranks of 2 rows each against the
  port's single process on the global batch (1e-6 relative) and against
  JAX ``make_train_step`` on one CPU device with the same weights and
  batches (2e-5, the JAX test's bound);
* (iii) each rank's rows of a Mixup, CutMix or label-smoothing blend, of
  fp32 and bf16 images, equal the single process's blend of the global
  batch bit for bit;
* (iv) at world size 1 the step equals the step without a group bit for bit;
  at world size 2 the ranks' drop-path generators differ;
* (v) two ranks over 7 videos at batch 2 give the single process's scores
  in dataset order (1e-6) and the same results;
* (vi) only rank 0 writes checkpoints; a SIGTERM to rank 1 alone stops both
  ranks at one step with one checkpoint; ``auto_resume`` on two ranks
  continues the uninterrupted trajectory (1e-6);
* (vii) the refusals: nccl on the CPU, nccl with two ranks on one card,
  ``launcher="pytorch"`` without torchrun's environment, shards of unequal
  size; and ``tools/dist_{train,test}_torch.sh`` over two CPU ranks;
* (viii) BatchNorm over the global batch: the 2D toy of
  ``tests/test_torch_recognizer2d_train.py`` (ResNetTSM-18, SGD with a
  clip, 3 steps of 4 clips) on two ranks of 2 clips against JAX's step on
  one device over the 4 clips, whose jit computes each BatchNorm's
  statistics over the whole batch: losses 1e-5 relative, tensors 1e-3 and
  running statistics 2e-5 sum-relative [readings: 5.0e-7, 3.2e-8,
  5.3e-7]. The same steps with each rank's own statistics (the gradients
  still averaged), run in one process, miss those bounds [0.13, 1.1e-2,
  0.11], so the test sees the ranks' statistics summed.

The two ranks are spawned once for the module (``tests/torch_dist_worker.py``,
which imports no JAX); the single-process references run here.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.core.optim import build_optimizer as jax_build_optimizer
from adapt_image_models_tpu.core.train_state import (
    create_train_state, make_train_step as jax_make_train_step,
)
from adapt_image_models_tpu.data.datasets import build_dataset as jax_build_dataset
from adapt_image_models_tpu.data.loader import VideoLoader as JaxVideoLoader
from adapt_image_models_tpu.models import build_model as build_jax_model
from adapt_image_models_tpu.parallel.partition import partition_params
from adapt_image_models_torch.apis import init_recognizer, run_evaluation, train_model
from adapt_image_models_torch.convert import params_from_jax
from adapt_image_models_torch.core.optim import build_optimizer
from adapt_image_models_torch.core.train_state import (
    TrainState, drop_generator, make_train_step, step_generator,
)
from adapt_image_models_torch.data.blending import build_blending
from adapt_image_models_torch.data.datasets import build_dataset
from adapt_image_models_torch.data.loader import VideoLoader
from adapt_image_models_torch.models import build_model
from adapt_image_models_torch.parallel import distributed, freeze_params, init_distributed

import torch_dist_worker as W
from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_recognizer2d_train import jax_trajectory, seeded_variables
from test_torch_resnet2d import _sum_rel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")


def _write_ann(path, n):
    # skewed classes, so that sample_by_class re-weights
    path.write_text("\n".join(f"synthetic://{i} {0 if i % 3 else i % W.CLASSES}"
                              for i in range(n)))
    return str(path)


def _close(got, want, rel, what):
    """sum |got - want| <= rel * sum |want|, per tensor. Not elementwise:
    Adam's first steps move an element by about lr whatever the size of its
    gradient, so an element whose gradient is near 0 moves by up to 2 lr
    when the order of a sum flips the gradient's last bits [measured, two
    ranks vs one process: 3.6e-7 on one element of a T_Adapter's D_fc1,
    sum-relative at most 1.2e-7 on any tensor]."""
    for name, w in want.items():
        err = float((got[name].double() - w.double()).abs().sum())
        assert err <= rel * float(w.double().abs().sum()), (what, name, err)


# ---- (i) loader shards ------------------------------------------------------

@pytest.mark.parametrize("epoch", [0, 1])
@pytest.mark.parametrize("mode", ["ordered", "shuffle", "sample_by_class"])
@pytest.mark.parametrize("world", [1, 2, 3])
@pytest.mark.parametrize("n", [7, 16, 33])
def test_loader_shards_match_jax(tmp_path, n, world, mode, epoch):
    """Every shard's indices equal the JAX loader's, padded by wrap to a
    multiple of the world size; the shards together are the padded order."""
    pipe = [dict(type="SampleFrames", clip_len=1, frame_interval=1, num_clips=1)]
    ds_cfg = dict(type="VideoDataset", ann_file=_write_ann(tmp_path / "ann.txt", n),
                  pipeline=pipe, sample_by_class=mode == "sample_by_class", power=0.5)
    port_ds, jax_ds = build_dataset(ds_cfg), jax_build_dataset(ds_cfg)
    shards = []
    for shard in range(world):
        loaders = [cls(ds, pipe, batch_size=2, shuffle=mode != "ordered", seed=3,
                       num_shards=world, shard_index=shard)
                   for cls, ds in ((VideoLoader, port_ds), (JaxVideoLoader, jax_ds))]
        for loader in loaders:
            loader.set_epoch(epoch)
        got, want = (loader._epoch_indices() for loader in loaders)
        np.testing.assert_array_equal(got, want)
        assert len(loaders[0]) == len(loaders[1])
        shards.append(got)
    per_shard = -(-n // world)
    assert {len(s) for s in shards} == {per_shard}
    padded = np.stack(shards, 1).reshape(-1)  # shard r holds padded[r::W]
    assert np.array_equal(padded[n:], padded[:per_shard * world - n])
    if mode != "sample_by_class":
        assert sorted(padded[:n]) == list(range(n))


# ---- the two-rank run ---------------------------------------------------------

@pytest.fixture(scope="module")
def jax_params():
    """The JAX toy's initialisation, with seeded values where JAX puts
    constants (the adapters' D_fc2, the temporal embedding), so that every
    trainable tensor gets a gradient."""
    model = build_jax_model(W.toy_model_cfg("xla"))
    params = model.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 3, W.T, W.RES, W.RES)))["params"]
    rng = np.random.default_rng(1)

    def visit(path, leaf):
        name = "/".join(str(getattr(k, "key", k)) for k in path)
        if "D_fc2" in name or "temporal_embedding" in name:
            return (0.05 * rng.standard_normal(leaf.shape)).astype(np.float32)
        return np.asarray(leaf)
    return jax.tree_util.tree_map_with_path(visit, params)


@pytest.fixture(scope="module")
def batches():
    rng = np.random.default_rng(100)
    return [(torch.from_numpy(rng.standard_normal(
                (W.GLOBAL_B, 1, 3, W.T, W.RES, W.RES)).astype(np.float32)),
             (np.arange(W.GLOBAL_B) + step) % W.CLASSES)
            for step in range(W.STEPS)]


@pytest.fixture(scope="module")
def blend_batch():
    rng = np.random.default_rng(5)
    return (torch.from_numpy(rng.standard_normal((8, 3, W.T, 8, 8)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, W.CLASSES, 8)))


@pytest.fixture(scope="module")
def cnn_variables():
    return seeded_variables(W.cnn_model_cfg(), seed=7)[1]


@pytest.fixture(scope="module")
def cnn_batches():
    rng = np.random.default_rng(200)
    return [(torch.from_numpy(rng.standard_normal(
                (W.GLOBAL_B, 4, 3, 32, 32)).astype(np.float32)),
             torch.from_numpy((np.arange(W.GLOBAL_B) + step) % W.CLASSES))
            for step in range(W.CNN_STEPS)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_params, batches, blend_batch, cnn_variables, cnn_batches):
    """Both ranks' outputs and the run's directory."""
    d = tmp_path_factory.mktemp("ranks")
    torch.save({"weights": params_from_jax(jax_params), "batches": batches,
                "cnn_weights": params_from_jax(cnn_variables), "cnn_batches": cnn_batches,
                "blend": blend_batch,
                "train_ann": _write_ann(d / "train.txt", W.TRAIN_VIDEOS),
                "eval_ann": _write_ann(d / "eval.txt", W.EVAL_VIDEOS)},
               d / "inputs.pt")
    env = dict(os.environ, WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(W.free_port()))
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen([sys.executable, WORKER, str(d)],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)), cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return d, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(2)]


def test_two_ranks_match_one_process(ranks, jax_params, batches):
    """Two ranks of 2 rows: the same losses, grad norms and tensors on both
    ranks, and those of one process on the global batch of 4 to 1e-6."""
    _, out = ranks
    assert [o["world"] for o in out] == [2, 2] and out[0]["device"] == "cpu"
    for key in ("loss", "grad_norm"):
        assert out[0]["train"][key] == out[1]["train"][key]
    for name, t in out[0]["train"]["trainable"].items():
        assert torch.equal(t, out[1]["train"]["trainable"][name]), name
    single = W.toy_trajectory(params_from_jax(jax_params), batches)
    got = out[0]["train"]
    np.testing.assert_allclose(got["loss"], single["loss"], rtol=1e-6)
    np.testing.assert_allclose(got["grad_norm"], single["grad_norm"], rtol=1e-6)
    _close(got["trainable"], single["trainable"], 1e-6, "two ranks vs one process")
    assert got["loss"][1] != got["loss"][0]


def test_two_ranks_match_jax(ranks, jax_params, batches):
    """Against the JAX package's train step on one CPU device over the same
    global batches: losses and trainable tensors to 2e-5."""
    jmodel = build_jax_model(W.toy_model_cfg("xla"))
    trainable, _ = partition_params(jax_params)
    tx = jax_build_optimizer(W.OPT, trainable, schedule=W.OPT["lr"])
    state = create_train_state(jax_params, tx)
    step = jax.jit(jax_make_train_step(jmodel, tx))
    losses = []
    for imgs, labels in batches:
        state, metrics = step(state, {"imgs": jnp.asarray(imgs.numpy()),
                                      "label": jnp.asarray(labels)},
                              jax.random.PRNGKey(0))
        losses.append(float(metrics["loss"]))
    got = ranks[1][0]["train"]
    np.testing.assert_allclose(got["loss"], losses, rtol=2e-5)
    want = params_from_jax(state.trainable)
    assert set(want) == set(got["trainable"])
    _close(got["trainable"], want, 2e-5, "two ranks vs JAX")


def _cnn_gaps(run, want_losses, want):
    loss = max(abs(a - b) / abs(b) for a, b in zip(run["loss"], want_losses))
    tensors = max(_sum_rel(run["state"][k], v) for k, v in want.items() if "running" not in k)
    stats = max(_sum_rel(run["state"][k], v) for k, v in want.items() if "running" in k)
    return loss, tensors, stats


def _local_statistics_run(weights, data):
    """The steps two ranks would take with each rank's own BatchNorm
    statistics: each half of the batch forward and backward alone, the
    gradients and losses averaged, rank 0's running statistics kept."""
    from adapt_image_models_torch.models.losses import cross_entropy
    model = build_model(W.cnn_model_cfg())
    model.load_state_dict(weights, strict=True)
    opt = build_optimizer(W.CNN_OPT, model, W.CNN_OPT["lr"], W.CNN_CLIP)
    model.train()
    losses = []
    for imgs, labels in data:
        half, grads, loss = len(imgs) // 2, None, 0.0
        for r in range(2):
            rows = slice(r * half, (r + 1) * half)
            part = cross_entropy(model(imgs[rows]), labels[rows])
            g = torch.autograd.grad(part, opt.params)
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
            loss += float(part) / 2
            if r == 0:
                kept = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        model.load_state_dict(kept, strict=False)
        opt.update([g / 2 for g in grads])
        losses.append(loss)
    return {"loss": losses, "state": model.state_dict()}


def test_two_ranks_batch_norm_matches_jax_global_batch(ranks, cnn_variables, cnn_batches):
    """(viii): two ranks' BatchNorms normalise with the global batch's
    statistics, as JAX's one-device step over the whole batch does; both
    ranks hold the same tensors and statistics; per-rank statistics would
    miss the bounds."""
    out = ranks[1]
    for k, v in out[0]["cnn"]["state"].items():
        assert torch.equal(v, out[1]["cnn"]["state"][k]), k
    data = [(imgs.numpy(), labels.numpy()) for imgs, labels in cnn_batches]
    want_losses, _, want = jax_trajectory(W.cnn_model_cfg(), cnn_variables, W.CNN_OPT,
                                          W.CNN_CLIP, 1, data)
    loss, tensors, stats = _cnn_gaps(out[0]["cnn"], want_losses, want)
    assert loss < 1e-5 and tensors < 1e-3 and stats < 2e-5, (loss, tensors, stats)
    local = _local_statistics_run(params_from_jax(cnn_variables), cnn_batches)
    loss, tensors, stats = _cnn_gaps(local, want_losses, want)
    assert loss > 1e-5 and tensors > 1e-3 and stats > 2e-5, (loss, tensors, stats)


@pytest.mark.parametrize("dtype", W.BLEND_DTYPES)
@pytest.mark.parametrize("kind", W.BLENDINGS)
def test_blend_rows_equal_global_blend(ranks, blend_batch, kind, dtype):
    """Each rank's blended rows and soft targets are the global blend's."""
    imgs, labels = blend_batch
    imgs = imgs.to(getattr(torch, dtype))
    want_imgs, want_targets = build_blending(W.blending_cfg(kind))(
        imgs, labels, step_generator(W.BLEND_SEED, W.BLEND_STEP, "cpu", 1))
    half = len(imgs) // 2
    for r, out in enumerate(ranks[1]):
        got_imgs, got_targets = out["blend"][(kind, dtype)]
        assert got_imgs.dtype == imgs.dtype
        assert torch.equal(got_imgs, want_imgs[r * half:(r + 1) * half]), (kind, r)
        assert torch.equal(got_targets, want_targets[r * half:(r + 1) * half]), (kind, r)


def test_drop_path_generators_differ_across_ranks(ranks):
    a, b = (out["drop"] for out in ranks[1])
    assert not torch.equal(a, b)


def _torchrun_env(monkeypatch, world=1, local_world=None):
    for key, value in dict(RANK="0", WORLD_SIZE=str(world), LOCAL_RANK="0",
                           LOCAL_WORLD_SIZE=str(local_world or world),
                           MASTER_ADDR="127.0.0.1", MASTER_PORT=str(W.free_port())).items():
        monkeypatch.setenv(key, value)


def _blended_trajectory():
    """Two train steps of the toy with drop path 0.3 and Mixup."""
    cfg = W.toy_model_cfg(drop_path=0.3)
    model = build_model(cfg)
    model.init_weights(torch.Generator().manual_seed(4))
    freeze_params(model)
    opt = build_optimizer(W.OPT, model, W.OPT["lr"])
    state = TrainState(model, opt)
    step = make_train_step(model, opt,
                           blending=build_blending(W.blending_cfg("MixupBlending")))
    rng = np.random.default_rng(9)
    metrics = []
    for _ in range(2):
        batch = {"imgs": torch.from_numpy(rng.standard_normal(
                     (3, 1, 3, W.T, W.RES, W.RES)).astype(np.float32)),
                 "label": rng.integers(0, W.CLASSES, 3)}
        metrics.append({k: float(v) for k, v in step(state, batch, 11).items()})
    return metrics, {n: p.detach().clone() for n, p in model.named_parameters()}


def test_world_size_one_is_the_undistributed_step(monkeypatch):
    """A gloo group of one rank: its drop-path generator is the unfolded
    one, and two blended, drop-path train steps equal those without a
    group bit for bit."""
    want_metrics, want_params = _blended_trajectory()
    _torchrun_env(monkeypatch)
    assert init_distributed(device="cpu") == torch.device("cpu")
    try:
        assert distributed.get_dist_info() == (0, 1)
        a = torch.rand(8, generator=drop_generator(3, 2, "cpu"))
        assert torch.equal(a, torch.rand(8, generator=step_generator(3, 2, "cpu")))
        got_metrics, got_params = _blended_trajectory()
    finally:
        torch.distributed.destroy_process_group()
    assert got_metrics == want_metrics
    for name, p in want_params.items():
        assert torch.equal(got_params[name], p), name


def test_distributed_eval_matches_one_process(ranks):
    """7 videos over two ranks at batch 2 (shard 1 padded by wrap with video
    0): every rank holds the single process's scores in dataset order."""
    d, out = ranks
    cfg = W.tiny_cfg(str(d / "eval.txt"), str(d / "eval"))
    model = init_recognizer(cfg, device="cpu", seed=0)
    results, scores, labels = run_evaluation(cfg, model=model, batch_size=2,
                                             num_workers=1, return_scores=True,
                                             device="cpu")
    assert scores.shape == (W.EVAL_VIDEOS, W.CLASSES)
    for o in out:
        got_results, got_scores, got_labels = o["eval"]
        np.testing.assert_allclose(got_scores, scores, rtol=0, atol=1e-6)
        assert np.array_equal(got_labels, labels)
        assert got_results == results


def test_only_rank_zero_writes_checkpoints(ranks):
    _, out = ranks
    assert out[0]["writes"] > 0 and out[1]["writes"] == 0


def test_auto_resume_continues_the_trajectory(ranks):
    """A two-rank run cut after its first epoch and resumed by auto_resume
    ends where the uninterrupted run ends (1e-6), on both ranks."""
    _, out = ranks
    for o in out:
        assert o["cut_latest"] == 1
        assert o["resumed"]["step"] == o["full"]["step"] == 2 * W.TRAIN_VIDEOS // 4
        _close(o["resumed"]["trainable"], o["full"]["trainable"], 1e-6, "resumed")
    for name, t in out[0]["full"]["trainable"].items():
        assert torch.equal(t, out[1]["full"]["trainable"][name]), name


def test_sigterm_to_one_rank_stops_both(ranks):
    """SIGTERM to rank 1 alone: both ranks stop at the same step of the
    first epochs, with one checkpoint of that epoch."""
    d, out = ranks
    steps = {o["sigterm"]["step"] for o in out}
    latest = {o["sigterm"]["latest"] for o in out}
    assert len(steps) == 1 and len(latest) == 1, (steps, latest)
    (epoch,) = latest
    assert epoch < 50 and steps.pop() > 0
    assert sorted(os.listdir(d / "sigterm")) == ["checkpoints.json", f"ckpt_{epoch}.pth"]
    meta = json.loads((d / "sigterm" / "checkpoints.json").read_text())
    assert meta["all"] == [epoch]


def test_unequal_shards_are_refused(ranks):
    """A global micro-batch of 3 over 2 ranks (2 rows on rank 0, 1 on rank
    1): train_model raises on both ranks when it builds the loader."""
    for o in ranks[1]:
        assert o["unequal"] and "does not split evenly over 2 ranks" in o["unequal"]


@pytest.mark.parametrize("case", ["nccl_on_cpu", "nccl_two_ranks_one_card",
                                  "no_torchrun_env", "unknown_launcher"])
def test_refusals(monkeypatch, tmp_path, case):
    if case == "nccl_on_cpu":
        _torchrun_env(monkeypatch)
        with pytest.raises(ValueError, match="nccl backend needs CUDA"):
            init_distributed("nccl", device="cpu")
    elif case == "nccl_two_ranks_one_card":
        _torchrun_env(monkeypatch, world=2)
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="no two ranks on one device"):
            init_distributed(device="cuda")
    else:
        for key in distributed.TORCHRUN_ENV:
            monkeypatch.delenv(key, raising=False)
        cfg = W.tiny_cfg(_write_ann(tmp_path / "a.txt", 4), str(tmp_path / "w"))
        launcher, match = (("pytorch", "needs torchrun's environment")
                           if case == "no_torchrun_env" else ("slurm", "launcher 'slurm'"))
        with pytest.raises(ValueError, match=match):
            train_model(cfg, device="cpu", launcher=launcher)
        with pytest.raises(ValueError, match=match):
            run_evaluation(cfg, device="cpu", launcher=launcher)
    assert not torch.distributed.is_initialized()


def test_dist_launchers_on_two_cpu_ranks(tmp_path):
    """tools/dist_train_torch.sh and tools/dist_test_torch.sh over two gloo
    ranks: 2 steps, a checkpoint and history.json from rank 0, then the
    checkpoint's scores, which one process reproduces."""
    cfg = W.tiny_cfg(_write_ann(tmp_path / "ann.txt", W.EVAL_VIDEOS), str(tmp_path / "w"))
    cfg_path = tmp_path / "tiny.py"
    cfg_path.write_text("\n".join(f"{k} = {v!r}" for k, v in cfg.items()) + "\n")
    env = dict(os.environ, PYTHON=sys.executable, PORT=str(W.free_port()))
    env.pop("XLA_FLAGS", None)
    work = tmp_path / "w"
    train = subprocess.run(
        ["bash", os.path.join(ROOT, "tools", "dist_train_torch.sh"), "2", str(cfg_path),
         "--device", "cpu", "--max-steps", "2", "--no-validate"],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert train.returncode == 0, train.stdout[-3000:] + train.stderr[-3000:]
    assert "rank / world: 0 / 2" in train.stdout and "done: 2 steps, 2 updates" in train.stdout
    history = json.loads((work / "history.json").read_text())
    assert len(history) == 2 and all(np.isfinite(h["grad_norm"]) for h in history)
    assert sorted(os.listdir(work)) == ["checkpoints.json", "ckpt_1.pth", "history.json",
                                        "train.log"]

    env["PORT"] = str(W.free_port())
    ckpt, scores_path = work / "ckpt_1.pth", tmp_path / "scores.npz"
    test = subprocess.run(
        ["bash", os.path.join(ROOT, "tools", "dist_test_torch.sh"), "2", str(cfg_path),
         "--device", "cpu", "--checkpoint", str(ckpt), "--dump-scores", str(scores_path)],
        capture_output=True, text=True, timeout=300, cwd=ROOT, env=env)
    assert test.returncode == 0, test.stdout[-3000:] + test.stderr[-3000:]
    results = [json.loads(line) for line in test.stdout.splitlines() if line.startswith("{")]
    model = init_recognizer(cfg, checkpoint=str(ckpt), device="cpu")
    want_results, want_scores, _ = run_evaluation(cfg, model=model, num_workers=1,
                                                  return_scores=True, device="cpu")
    assert results == [want_results]  # printed by rank 0 alone
    np.testing.assert_allclose(np.load(scores_path)["scores"], want_scores, rtol=0, atol=1e-6)
