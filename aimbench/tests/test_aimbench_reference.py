"""The plain reference (``aimbench/reference/aim.py``) against the port's
plain path at a tiny size on the CPU: the framework-op AIM in float32
(``attention_core="xla"``, exact GELU), its eval forward, its train-mode
forward and gradients under the same drop-path and dropout draws, the
optimizer's groups, AdamW update and learning-rate schedule; and the
parameter names and shapes of both configurations."""

import numpy as np
import pytest
import torch

from tiny_cells import tiny
from aimbench import cells, spec
from aimbench.inputs import draw_pool, draw_weights
from aimbench.reference import aim as ref

CELLS = ("aim-b16-8f.train-b32", "aim-l14-32f.train-b8")


def _port(conf, **backbone):
    from adapt_image_models_torch.apis.inference import model_config
    from adapt_image_models_torch.models import build_model
    cfg = cells.port_config(conf)
    mc = model_config(cfg, "train")
    mc.pop("test_cfg", None)
    mc.pop("train_cfg", None)
    mc["backbone"] = {**mc["backbone"], **backbone}
    return cfg, build_model(mc, device="cpu" if backbone else "meta")


@pytest.mark.parametrize("workload", CELLS)
def test_param_spec_names_the_ports_parameters(workload):
    conf = spec.resolve(workload)["config"]
    _, model = _port(conf)
    got = sorted((n, tuple(p.shape)) for n, p in model.named_parameters())
    assert got == sorted(ref.param_spec(conf["model"]))


def _tiny_pair(workload="aim-b16-8f.train-b32", seed=3):
    conf = tiny(workload)["config"]
    m = conf["model"]
    cfg, model = _port(conf, attention_core="xla", compute_dtype="float32")
    weights = draw_weights(ref.param_spec(m), seed, m["width"], "cpu")
    model.load_state_dict(weights)
    P = {k: v.clone() for k, v in weights.items()}
    return conf, cfg, model, P


@pytest.mark.parametrize("workload", CELLS)
def test_eval_forward_matches_the_plain_path(workload):
    conf, _, model, P = _tiny_pair(workload)
    m = conf["model"]
    r = m["input_resolution"]
    pool = draw_pool(5, 1, (2, 3, m["num_frames"], r, r, 3), m["num_classes"], "cpu")
    imgs = torch.from_numpy(pool[0]["imgs"])
    x = ref.normalize(imgs, conf["mean"], conf["std"]).reshape(6, 3, m["num_frames"], r, r)
    with torch.no_grad():
        want = torch.softmax(model.eval()(x), -1).reshape(2, 3, -1).mean(1)
    got = ref.eval_scores(P, imgs, conf, 3, chunk=4)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)


def test_train_gradients_match_the_plain_path_under_the_same_draws():
    from adapt_image_models_torch.core.train_state import drop_generator
    from adapt_image_models_torch.parallel import freeze_params
    conf, _, model, P = _tiny_pair()
    m = conf["model"]
    seed, step = 2 ** 35 + 17, 4
    r = m["input_resolution"]
    pool = draw_pool(seed, 1, (3, 1, m["num_frames"], r, r, 3), m["num_classes"], "cpu")
    imgs, labels = torch.from_numpy(pool[0]["imgs"]), torch.from_numpy(pool[0]["label"])
    freeze_params(model)
    model.train()
    x = ref.normalize(imgs[:, 0], conf["mean"], conf["std"])
    loss = torch.nn.functional.cross_entropy(model(x, generator=drop_generator(seed, step, "cpu")),
                                             labels)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    want = torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])
    tr = ref.Trainer(P, conf, chunk=2, recompute=True)
    assert sorted(tr.names) == sorted(names)
    got_loss, got = tr.gradients(imgs, labels, seed, step)
    assert got_loss == pytest.approx(loss.detach().item(), rel=1e-6)
    for n, w in zip(names, want):
        torch.testing.assert_close(got[n], w, rtol=1e-4, atol=1e-7)


@pytest.mark.parametrize("workload", CELLS)
def test_adamw_groups_and_schedule_match_the_ports(workload):
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.schedule import build_schedule
    from adapt_image_models_torch.parallel import freeze_params
    conf, cfg, model, P = _tiny_pair(workload)
    freeze_params(model)
    sched = conf["schedule"]
    schedule = build_schedule(cfg["lr_config"], cfg["optimizer"]["lr"], cfg["total_epochs"],
                              sched["steps_per_epoch"])
    for k in (0, 1, 2, 1000, sched["steps_per_epoch"] * 3, sched["steps_per_epoch"] * 29):
        assert ref.learning_rate(sched, conf["optimizer"]["lr"], k) == pytest.approx(
            schedule(k), rel=1e-12)
    optimizer = build_optimizer(cfg["optimizer"], model, schedule)
    tr = ref.Trainer(P, conf)
    names = [n for n, p in model.named_parameters() if p.requires_grad]
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        grads = [torch.randn(p.shape, generator=gen) for p in optimizer.params]
        optimizer.update(grads)
        tr.update(dict(zip(names, grads)))
    for n, p in zip(names, optimizer.params):
        torch.testing.assert_close(tr.P[n], p.detach(), rtol=1e-6, atol=1e-8)
    for group in optimizer.param_groups:
        for n in group["names"]:
            assert tr.decays(n) == (group["weight_decay"] > 0)
            assert tr.lr_mult(n) == group["lr_mult"]
    assert conf["optimizer"]["lr"] == cfg["optimizer"]["lr"]
    assert conf["optimizer"]["weight_decay"] == cfg["optimizer"]["weight_decay"]
    assert tuple(conf["optimizer"]["betas"]) == tuple(cfg["optimizer"]["betas"])


@pytest.mark.parametrize("workload", CELLS)
def test_config_file_holds_the_repo_configs_numbers(workload):
    conf = spec.resolve(workload)["config"]
    cfg = cells.port_config(conf)
    bb, head, m = cfg["model"]["backbone"], cfg["model"]["cls_head"], conf["model"]
    for k in ("layers", "width", "heads", "patch_size", "input_resolution", "num_frames",
              "adapter_scale", "drop_path_rate", "compute_dtype", "attention_core"):
        assert bb[k] == m[k], k
    assert bool(bb.get("use_checkpoint", False)) == m["use_checkpoint"]
    assert (head["num_classes"], head["dropout_ratio"]) == (m["num_classes"], m["dropout_ratio"])
    lr = cfg["lr_config"]
    assert lr["policy"] == conf["schedule"]["policy"] and lr["warmup_by_epoch"]
    assert (lr["warmup_iters"], lr.get("warmup_ratio", 0.1), lr["min_lr"], cfg["total_epochs"]) == (
        conf["schedule"]["warmup_epochs"], conf["schedule"]["warmup_ratio"],
        conf["schedule"]["min_lr"], conf["schedule"]["total_epochs"])
    norm = next(p for p in cfg["data"]["train"]["pipeline"] if p["type"] == "Normalize")
    assert list(norm["mean"]) == conf["mean"] and list(norm["std"]) == conf["std"]


def test_fp8_control_rounds_every_product():
    a = torch.randn(64, 64)
    q = ref.round_fp8(a)
    assert torch.unique(q / (a.abs().max() / ref.FP8_MAX)).numel() <= 256
    assert not torch.equal(q, a) and (q - a).abs().max() <= 0.07 * a.abs().max()
    assert np.isclose(float(ref.round_fp8(torch.tensor([448.0, 1.0]))[0]), 448.0)
