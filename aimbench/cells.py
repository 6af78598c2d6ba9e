"""The two kinds of cell: a train mix and a multi-view eval mix, each
driving the port's own entry points as ``apis/train.py::train_model`` and
``apis/test.py::run_evaluation`` assemble them, then the plain reference.

A cell's life: ``setup`` (build on the device, draw the weights and the
batch pool from the seed, run the first calls, which warm every shape the
window uses and give the program's side of the check), ``window`` (a
closed loop for ``seconds``), optionally ``trace``, ``release`` (the
program's state freed), then ``reference`` and ``numbers``.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from aimbench import check, trace
from aimbench.inputs import draw_pool, draw_weights
from aimbench.reference import aim as ref_aim
from aimbench.spec import ROOT


def port_config(conf: dict) -> dict:
    """The repo configuration the cell runs, with its options, as the
    port's entry points load it."""
    from adapt_image_models_torch.apis.inference import load_config
    return load_config(str(ROOT / conf["repo_config"]), list(conf.get("options", [])))


def build_model(conf: dict, cfg: dict, split: str, seed: int, device):
    """The recognizer of ``cfg`` for ``split``'s samples on ``device``,
    every parameter drawn from ``seed`` (``inputs.draw_weights``)."""
    from adapt_image_models_torch.apis.inference import model_config
    from adapt_image_models_torch.models import build_model as port_build
    mcfg = model_config(cfg, split)
    test_cfg, train_cfg = mcfg.pop("test_cfg", None), mcfg.pop("train_cfg", None)
    model = port_build(mcfg, train_cfg=train_cfg, test_cfg=test_cfg, device=device)
    m = conf["model"]
    weights = draw_weights(ref_aim.param_spec(m), seed, int(m["width"]), device)
    model.load_state_dict(weights, strict=True)
    return model


def normalize_cfg(pipeline):
    for item in pipeline:
        if item.get("type") == "Normalize":
            return item["mean"], item["std"]
    raise ValueError("the pipeline has no Normalize")


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Cell:
    """State shared by both kinds: the cell's files, the seed, the device
    and what the run has measured so far."""

    def __init__(self, cell: dict, seed: int, device="cuda"):
        self.cell, self.seed, self.device = cell, int(seed), device
        self.conf, self.mix = cell["config"], cell["traffic"]
        self.m = self.conf["model"]
        self.pool: List[dict] = []
        self.measured: Dict = {"setup": {}}
        self._t = time.perf_counter()

    def _phase(self, name: str) -> None:
        """Keep the set-up's seconds since the last phase under ``name``."""
        now = time.perf_counter()
        self.measured["setup"][name] = now - self._t
        self._t = now

    def _loop(self, seconds: float, call) -> None:
        """Closed loop: ``call(i)`` until the host clock passes ``seconds``
        after the first, then wait for the device. Every call records a
        CUDA event at its end, read once the window has closed."""
        cuda = torch.device(self.device).type == "cuda"
        marks = []
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        n = 0
        while True:
            call(n)
            n += 1
            if cuda:
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                marks.append(e)
            if time.perf_counter() - t0 >= seconds:
                break
        sync(self.device)
        t1 = time.perf_counter()
        gaps = [a.elapsed_time(b) for a, b in zip([start] + marks[:-1], marks)] if cuda else []
        self.measured["window"] = {"seconds": t1 - t0, "calls": n, "call_ms": gaps}

    def release(self) -> None:
        """Free the program's state before the reference runs."""
        for name in ("model", "state", "optimizer", "step_fn", "metrics"):
            self.__dict__.pop(name, None)
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def trace(self, outdir, tag: str) -> None:
        """The traced run's sub-windows: the host's dispatch, each call
        from an idle device to its return, then the two profiled ones
        (``aimbench/trace.py``)."""
        n, nr = int(self.mix["trace_calls"]), int(self.mix["roofline_calls"])
        host = 0.0
        for i in range(n):
            sync(self.device)
            host += self.call(i)
        self.measured["dispatch_ms"] = host / n * 1e3
        plain = trace.profile(self.call, n, str(outdir / f"{tag}.trace.json"))
        self.measured["timeline"] = trace.timeline(plain)
        with trace.launch_mode():
            shapes = trace.profile(self.call, nr, str(outdir / f"{tag}.shapes.json"),
                                   shapes=True)
        self.measured["rooflines"] = trace.rooflines(shapes)


class TrainCell(Cell):
    kind = "train"

    def draw(self) -> None:
        """The pool of host batches: (B, 1, T, H, W, 3) uint8 clips."""
        b, t, r = (int(self.mix["clips_per_step"]), int(self.m["num_frames"]),
                   int(self.m["input_resolution"]))
        self.pool = draw_pool(self.seed, int(self.mix["pool"]), (b, 1, t, r, r, 3),
                              int(self.m["num_classes"]), self.device)

    def setup(self) -> None:
        from adapt_image_models_torch.apis.train import freeze_for_training
        from adapt_image_models_torch.core.optim import build_optimizer
        from adapt_image_models_torch.core.schedule import build_schedule
        from adapt_image_models_torch.core.train_state import TrainState, make_train_step
        from adapt_image_models_torch.data.blending import build_blending
        from adapt_image_models_torch.data.transforms import layout_from_pipeline, make_prepare_fn
        from adapt_image_models_torch.models import build_loss
        from adapt_image_models_torch.models.layers import resolve_dtype

        cfg = port_config(self.conf)
        model = build_model(self.conf, cfg, "train", self.seed, self.device)
        model_cfg = cfg["model"]
        backbone_cfg = model_cfg.get("backbone", {})
        freeze_for_training(model, backbone_cfg)
        pipeline = cfg["data"]["train"]["pipeline"]
        mean, std = normalize_cfg(pipeline)
        prepare = make_prepare_fn(mean, std, dtype=resolve_dtype(backbone_cfg.get("compute_dtype")),
                                  layout=layout_from_pipeline(pipeline), device=self.device)
        opt_config = cfg.get("optimizer_config") or {}
        grad_clip = opt_config.get("grad_clip")
        if isinstance(grad_clip, dict):
            grad_clip = grad_clip.get("max_norm")
        sched = self.conf["schedule"]
        schedule = build_schedule(cfg.get("lr_config", {}), cfg["optimizer"]["lr"],
                                  int(cfg.get("total_epochs", 1)), int(sched["steps_per_epoch"]))
        optimizer = build_optimizer(cfg["optimizer"], model, schedule, grad_clip,
                                    int(opt_config.get("update_interval", 1)))
        loss_cfg = dict(model_cfg.get("cls_head", {})).get("loss_cls")
        self.step_fn = make_train_step(
            model, optimizer, prepare, build_loss(loss_cfg) if loss_cfg else None,
            build_blending((model_cfg.get("train_cfg") or {}).get("blending")))
        self.model, self.optimizer = model, optimizer
        self.state = TrainState(model, optimizer)
        self.log_interval = int((cfg.get("log_config") or {}).get("interval", 20))

        self._phase("build")
        self.draw()
        self._phase("draw")
        # the first steps, through the window's own call: they warm the
        # window's shapes and are checked
        names = [n for n, p in model.named_parameters() if p.requires_grad]
        params = optimizer.params
        start = [p.detach().clone() for p in params]
        losses, grad = [], {}
        for s in range(int(self.mix["check_steps"])):
            self.call(s)
            losses.append(float(self.metrics["loss"]))
            if s == 0:  # the first gradient, from AdamW's first moment
                for n, p in zip(names, params):
                    moment = optimizer.torch.state.get(p, {}).get("exp_avg")
                    beta1 = next(g["betas"][0] for g in optimizer.param_groups
                                 if any(q is p for q in g["params"]))
                    grad[n] = (0.0 if moment is None
                               else float(moment.double().norm()) / (1.0 - beta1))
        change = {n: float((p.detach() - p0).double().norm())
                  for n, p, p0 in zip(names, params, start)}
        del start
        self.program = {"losses": losses, "grad": grad, "change": change}
        sync(self.device)
        self._phase("first calls")

    def call(self, i: int) -> float:
        """Step ``i`` on pool batch ``i % pool``, enqueued as the train loop
        enqueues it, after the previous step's return; returns the host
        seconds to the step's return."""
        t = time.perf_counter()
        self.metrics = self.step_fn(self.state, self.pool[i % len(self.pool)], self.seed)
        host = time.perf_counter() - t
        if self.state.step % self.log_interval == 0:  # the train loop's log read
            {key: float(v) for key, v in self.metrics.items()}
        return host

    def window(self, seconds: float) -> None:
        k = int(self.mix["check_steps"])
        self._loop(seconds, lambda i: self.call(k + i))
        self.measured["window"]["units"] = (self.measured["window"]["calls"]
                                            * int(self.mix["clips_per_step"]))

    def reference(self, variant: str = "fp32") -> dict:
        """The reference's readings of the checked steps: ``fp32``, or the
        control ``fp8``, or the faults ``half`` (the loss over the first
        half of each batch) and ``lr1.1`` (every learning rate 1.1 times)."""
        ref_aim.use_fp32()
        P = draw_weights(ref_aim.param_spec(self.m), self.seed, int(self.m["width"]), self.device)
        tr = ref_aim.Trainer(P, self.conf, fp8=variant == "fp8",
                             chunk=int(self.conf["reference"]["train_chunk"]), recompute=True,
                             lr_scale=1.1 if variant == "lr1.1" else 1.0)
        start = {n: P[n].detach().clone() for n in tr.names}
        losses, grad = [], {}
        b = int(self.mix["clips_per_step"])
        for s in range(int(self.mix["check_steps"])):
            batch = self.pool[s]
            imgs = torch.from_numpy(batch["imgs"]).to(self.device)
            labels = torch.from_numpy(batch["label"]).to(self.device)
            loss, grads = tr.step(imgs, labels, self.seed, s, b // 2 if variant == "half" else None)
            losses.append(loss)
            if s == 0:
                grad = {n: float(g.double().norm()) for n, g in grads.items()}
        change = {n: float((P[n].detach() - start[n]).double().norm()) for n in tr.names}
        return {"losses": losses, "grad": grad, "change": change}

    def numbers(self, prog: dict, ref: dict) -> Dict[str, float]:
        return check.train_numbers(prog, ref)


class EvalCell(Cell):
    kind = "eval"

    def draw(self) -> None:
        """The pool of host batches: (B, V, T, H, W, 3) uint8 videos."""
        b, t, r = (int(self.mix["videos_per_call"]), int(self.m["num_frames"]),
                   int(self.m["input_resolution"]))
        self.pool = draw_pool(self.seed, int(self.mix["pool"]),
                              (b, int(self.mix["views"]), t, r, r, 3),
                              int(self.m["num_classes"]), self.device,
                              self.mix.get("view_levels"))

    def setup(self) -> None:
        from adapt_image_models_torch.apis.test import make_chunked_eval_step
        from adapt_image_models_torch.data.pipeline import build_sample_processor
        from adapt_image_models_torch.data.transforms import layout_from_pipeline, make_prepare_fn
        from adapt_image_models_torch.models.layers import resolve_dtype

        cfg = port_config(self.conf)
        model = build_model(self.conf, cfg, "test", self.seed, self.device).eval()
        test_cfg = cfg["model"].get("test_cfg") or {}
        pipeline = cfg["data"]["test"]["pipeline"]
        proc = build_sample_processor(pipeline)
        views = int(self.mix["views"])
        if int(proc.sampler.num_clips) != views:
            raise ValueError(f"the mix scores {views} views; the test pipeline samples "
                             f"{proc.sampler.num_clips}")
        layout = layout_from_pipeline(pipeline)
        prepare = make_prepare_fn(proc.mean, proc.std, dtype=resolve_dtype(
            cfg["model"].get("backbone", {}).get("compute_dtype")), layout=layout,
            device=self.device)
        self.step_fn = make_chunked_eval_step(model, prepare, test_cfg.get("average_clips", "prob"),
                                              test_cfg.get("max_testing_views"),
                                              segment_layout=layout != "NCTHW")
        self.model = model
        self._phase("build")
        self.draw()
        self._phase("draw")
        self.answers = []
        for i in range(int(self.mix["warmup_calls"])):
            self.call(i)
        self.program = {"answers": self.answers}
        sync(self.device)
        self._phase("first calls")

    def call(self, i: int) -> float:
        """One multi-view call on the next pool batch, its scores read to
        the host as run_evaluation gathers them; returns the host seconds
        to the step's return, before that read waits."""
        idx = i % len(self.pool)
        t = time.perf_counter()
        scores = self.step_fn(self.pool[idx]["imgs"])
        host = time.perf_counter() - t
        self.answers.append((idx, scores.cpu().numpy()))
        return host

    def window(self, seconds: float) -> None:
        k = int(self.mix["warmup_calls"])
        self._loop(seconds, lambda i: self.call(k + i))
        self.measured["window"]["units"] = (self.measured["window"]["calls"]
                                            * int(self.mix["videos_per_call"]))

    def reference(self, variant: str = "fp32") -> dict:
        """The reference's scores of each pool batch: ``fp32``, or the
        control ``fp8``, or the fault ``view`` (the last view left out of
        the average)."""
        ref_aim.use_fp32()
        P = draw_weights(ref_aim.param_spec(self.m), self.seed, int(self.m["width"]), self.device)
        chunk = int(self.conf["reference"]["eval_chunk"])
        scores = {}
        for idx, batch in enumerate(self.pool):
            imgs = torch.from_numpy(batch["imgs"]).to(self.device)
            views = int(self.mix["views"])
            scores[idx] = ref_aim.eval_scores(P, imgs, self.conf, views, fp8=variant == "fp8",
                                              chunk=chunk,
                                              kept=views - 1 if variant == "view" else None
                                              ).cpu().numpy()
        return {"scores": scores}

    def numbers(self, prog: dict, ref: dict) -> Dict[str, float]:
        return check.eval_numbers(prog["answers"], ref["scores"], int(self.mix["videos_per_call"]))


KINDS = {"train": TrainCell, "eval": EvalCell}


def make(cell: dict, seed: int, device="cuda") -> Cell:
    return KINDS[cell["traffic"]["kind"]](cell, seed, device)


def as_program(kind: str, ref: dict) -> dict:
    """A reference's readings put in the program's place (the control and
    the faults): an eval reference answers each pool batch once."""
    if kind == "eval":
        return {"answers": list(ref["scores"].items())}
    return ref


def altered(prog: dict) -> dict:
    """The fault of an answer altered where it is produced: the first
    video's class probabilities of the first answer rolled by one class."""
    answers = [(i, s.copy()) for i, s in prog["answers"]]
    answers[0][1][0] = np.roll(answers[0][1][0], 1)
    return {"answers": answers}


def unchanged(prog: dict) -> dict:
    """The fault of a step that returns its state unchanged: the
    parameters never move."""
    return {**prog, "change": {n: 0.0 for n in prog["change"]}}
