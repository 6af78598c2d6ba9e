"""One rank of the two-rank CPU run of ``tests/test_torch_distributed.py``:
gloo on the CPU, joined through ``init_distributed`` from the environment
torchrun would set (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR,
MASTER_PORT), which the test sets.

    python tests/torch_dist_worker.py <dir>

reads ``<dir>/inputs.pt`` (weights, global batches, annotation files) and
writes ``<dir>/rank<r>.pt`` with what each of the test's parts reads. It
imports no JAX: a rank is a process of the port. The configs here are the
test's too, which runs the single-process references.

    python tests/torch_dist_worker.py <dir> slowfast

runs only the SGD steps of the toy SlowFast of
``tests/test_torch_recognizer3d_cnn_train.py`` on this rank's rows.

    python tests/torch_dist_worker.py <dir> omnisource

runs ``train_model`` on the OmniSource recipe of ``<dir>/inputs.pkl``
(``tests/test_torch_omnisource.py``: a config and a step count) and writes
the rank's history and trained tensors.
"""

import os
import signal
import socket
import sys
import threading
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the toy AIM of tests/test_runtime/test_two_process_distributed.py
RES, PATCH, D, HEADS, LAYERS, T, CLASSES = 32, 16, 64, 4, 2, 4, 5
GLOBAL_B, STEPS = 4, 2
OPT = dict(type="AdamW", lr=1e-3, betas=(0.9, 0.999), weight_decay=0.05)
BLENDINGS = ("MixupBlending", "CutmixBlending", "LabelSmoothing")
BLEND_DTYPES = ("float32", "bfloat16")
BLEND_SEED, BLEND_STEP = 7, 3
EVAL_VIDEOS, TRAIN_VIDEOS, VIDEOS_PER_RANK = 7, 8, 2
# the 2D toy of tests/test_torch_recognizer2d_train.py: ResNetTSM-18 at
# stage_blocks (1, 1, 1, 1), 16 base channels, 4 segments of 32² frames
CNN_STEPS = 3
CNN_OPT = dict(type="SGD", lr=0.05, momentum=0.9, weight_decay=1e-3)
CNN_CLIP = 0.5


def toy_model_cfg(core="fused", drop_path=0.0):
    return dict(
        type="Recognizer3D",
        backbone=dict(type="AIM", input_resolution=RES, patch_size=PATCH, width=D,
                      layers=LAYERS, heads=HEADS, num_frames=T,
                      drop_path_rate=drop_path, attention_core=core),
        cls_head=dict(type="I3DHead", num_classes=CLASSES, in_channels=D,
                      dropout_ratio=0.0),
        test_cfg=dict(average_clips="prob"))


def cnn_model_cfg():
    return dict(type="Recognizer2D",
                backbone=dict(type="ResNetTSM", depth=18, num_frames=4,
                              stage_blocks=(1, 1, 1, 1), base_channels=16),
                cls_head=dict(type="TSMHead", num_classes=CLASSES, in_channels=128,
                              num_segments=4, dropout_ratio=0.0))


def slowfast_model_cfg():
    """The toy SlowFast: base width 16 (the Fast pathway 2 wide), alpha 4,
    one block a stage, over 8 frames of 32²."""
    return dict(type="Recognizer3D",
                backbone=dict(type="ResNet3dSlowFast", alpha=4, base_channels=16,
                              stage_blocks=(1, 1, 1, 1)),
                cls_head=dict(type="SlowFastHead", num_classes=CLASSES, in_channels=512 + 64,
                              dropout_ratio=0.0))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def cnn_trajectory(weights, batches, rows=slice(None), cfg=None):
    """SGD steps of the 2D toy (or of ``cfg``) on ``rows`` of each global
    batch: losses, and every tensor and running statistic after them.
    Under a process group every BatchNorm normalises with the global
    batch's statistics."""
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.models import build_model
    model = build_model(cfg or cnn_model_cfg())
    model.load_state_dict(weights, strict=True)
    opt = build_optimizer(CNN_OPT, model, CNN_OPT["lr"], CNN_CLIP)
    state, step = TrainState(model, opt), make_train_step(model, opt)
    losses = [float(step(state, {"imgs": imgs[rows], "label": labels[rows]}, 0)["loss"])
              for imgs, labels in batches]
    return {"loss": losses, "state": {k: v.clone() for k, v in model.state_dict().items()}}


def blending_cfg(kind):
    return dict(type=kind, num_classes=CLASSES, alpha=0.4)


def tiny_cfg(ann, work_dir, epochs=2, videos_per_gpu=VIDEOS_PER_RANK):
    """A train and eval recipe of the toy AIM (one layer, drop path on) over
    ``synthetic://`` videos; a constant learning rate, so that a run cut
    at an epoch's end and resumed follows the uninterrupted one."""
    pipe_train = [
        dict(type="SampleFrames", clip_len=T, frame_interval=2, num_clips=1),
        dict(type="Resize", scale=(-1, 36)),
        dict(type="RandomResizedCrop"),
        dict(type="Resize", scale=(RES, RES), keep_ratio=False),
        dict(type="Flip", flip_ratio=0.5),
        dict(type="Normalize"),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    pipe_test = [
        dict(type="SampleFrames", clip_len=T, frame_interval=2, num_clips=2,
             test_mode=True),
        dict(type="Resize", scale=(-1, RES)),
        dict(type="CenterCrop", crop_size=RES),
        dict(type="Normalize"),
        dict(type="FormatShape", input_format="NCTHW"),
    ]
    model = toy_model_cfg(drop_path=0.1)
    model["backbone"]["layers"] = 1
    return dict(
        model=dict(model, train_cfg=dict(blending=blending_cfg("MixupBlending"))),
        data=dict(
            videos_per_gpu=videos_per_gpu, workers_per_gpu=1,
            val_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
            test_dataloader=dict(videos_per_gpu=2, workers_per_gpu=1),
            train=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_train),
            val=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_test),
            test=dict(type="VideoDataset", ann_file=ann, pipeline=pipe_test)),
        optimizer=dict(OPT, lr=1e-2),
        optimizer_config=dict(grad_clip=dict(max_norm=1.0)),
        total_epochs=epochs,
        checkpoint_config=dict(interval=1),
        log_config=dict(interval=1),
        evaluation=dict(interval=1, save_best="top1_acc"),
        work_dir=work_dir)


def trainable(model):
    return {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}


def toy_trajectory(weights, batches, rows=slice(None)):
    """The toy model's train steps over ``batches`` (each rank passes its
    rows of the global batch): losses, grad norms, trainable tensors."""
    from adapt_image_models_torch.core.optim import build_optimizer
    from adapt_image_models_torch.core.train_state import TrainState, make_train_step
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.parallel import freeze_params
    model = build_model(toy_model_cfg())
    model.load_state_dict(weights, strict=True)
    freeze_params(model)
    opt = build_optimizer(OPT, model, OPT["lr"])
    state, step = TrainState(model, opt), make_train_step(model, opt)
    losses, norms = [], []
    for imgs, labels in batches:
        m = step(state, {"imgs": imgs[rows], "label": labels[rows]}, 0)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": norms, "trainable": trainable(model)}


class WriteLog:
    """Counts this process's checkpoint and record writes."""

    def __init__(self):
        from adapt_image_models_torch.core.checkpoint import CheckpointManager
        self.count = 0
        log = self
        for name in ("_write", "_write_meta"):
            orig = getattr(CheckpointManager, name)

            def counted(*args, _orig=orig, **kwargs):
                log.count += 1
                return _orig(*args, **kwargs)
            setattr(CheckpointManager, name,
                    staticmethod(counted) if name == "_write" else counted)


def sigterm_when_armed():
    """SIGTERM to this process once train_model's handler is installed."""
    for _ in range(1200):
        if signal.getsignal(signal.SIGTERM) not in (signal.SIG_DFL, None):
            os.kill(os.getpid(), signal.SIGTERM)
            return
        time.sleep(0.05)


def slowfast_main(out_dir):
    from adapt_image_models_torch.parallel import get_dist_info, init_distributed
    init_distributed(device="cpu")
    rank, world = get_dist_info()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    per = len(inp["slowfast_batches"][0][0]) // world
    out = cnn_trajectory(inp["slowfast_weights"], inp["slowfast_batches"],
                         slice(rank * per, (rank + 1) * per), slowfast_model_cfg())
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def omnisource_main(out_dir):
    import pickle
    from adapt_image_models_torch.apis import train_model
    from adapt_image_models_torch.parallel import get_dist_info
    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    state, history = train_model(inp["cfg"], seed=0, device="cpu", launcher="pytorch",
                                 max_steps=inp["steps"], validate=False)
    rank = get_dist_info()[0]
    torch.save({"history": history,
                "trained": {n: p.detach().clone() for n, p in state.model.named_parameters()}},
               os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def main(out_dir):
    torch.set_num_threads(1)
    from adapt_image_models_torch.apis import init_recognizer, run_evaluation, train_model
    from adapt_image_models_torch.core.checkpoint import CheckpointManager
    from adapt_image_models_torch.core.train_state import (
        blend_global, drop_generator, step_generator,
    )
    from adapt_image_models_torch.data.blending import build_blending
    from adapt_image_models_torch.parallel import get_dist_info, init_distributed

    device = init_distributed(device="cpu")
    rank, world = get_dist_info()
    inp = torch.load(os.path.join(out_dir, "inputs.pt"), weights_only=False)
    per = GLOBAL_B // world
    out = {"device": str(device), "world": world}

    # (ii) the toy's train steps on this rank's rows of each global batch
    out["train"] = toy_trajectory(inp["weights"], inp["batches"],
                                  slice(rank * per, (rank + 1) * per))
    # (viii) the 2D toy's SGD steps on this rank's rows: BatchNorm over
    # the global batch
    out["cnn"] = cnn_trajectory(inp["cnn_weights"], inp["cnn_batches"],
                                slice(rank * per, (rank + 1) * per))
    # (vii) shards of 2 and 1 rows: one global micro-batch of 3, which
    # train_model refuses when it builds the loader
    try:
        train_model(tiny_cfg(inp["train_ann"], os.path.join(out_dir, "unequal"),
                             videos_per_gpu=2 - rank),
                    seed=0, device="cpu", launcher="pytorch")
        out["unequal"] = None
    except ValueError as e:
        out["unequal"] = str(e)

    # (iii) this rank's rows of the global blend
    imgs, labels = inp["blend"]
    rows = slice(rank * len(imgs) // world, (rank + 1) * len(imgs) // world)
    out["blend"] = {(kind, dtype): blend_global(
                        build_blending(blending_cfg(kind)), imgs[rows].to(getattr(torch, dtype)),
                        labels[rows], step_generator(BLEND_SEED, BLEND_STEP, "cpu", 1))
                    for kind in BLENDINGS for dtype in BLEND_DTYPES}
    # (iv) the drop-path generator's draws
    out["drop"] = torch.rand(16, generator=drop_generator(0, 5, "cpu"))

    # (v) evaluation of the seeded toy over the eval split
    cfg = tiny_cfg(inp["eval_ann"], os.path.join(out_dir, "eval"))
    model = init_recognizer(cfg, device="cpu", seed=0)
    out["eval"] = run_evaluation(cfg, model=model, batch_size=2, num_workers=1,
                                 return_scores=True, device="cpu")

    # (vi) checkpoints: an uninterrupted run, one cut at its first epoch's
    # end and resumed, and one stopped by a SIGTERM sent to rank 1 alone
    writes = WriteLog()
    full, _ = train_model(tiny_cfg(inp["train_ann"], os.path.join(out_dir, "full")),
                          seed=0, device="cpu", launcher="pytorch")
    out["full"] = {"step": full.step, "trainable": trainable(full.model)}
    steps_per_epoch = TRAIN_VIDEOS // (VIDEOS_PER_RANK * world)
    cut_cfg = tiny_cfg(inp["train_ann"], os.path.join(out_dir, "resumed"))
    cut, _ = train_model(cut_cfg, seed=0, device="cpu", max_steps=steps_per_epoch)
    out["cut_latest"] = CheckpointManager(cut_cfg["work_dir"]).latest_epoch()
    resumed, _ = train_model(cut_cfg, seed=0, device="cpu", auto_resume=True)
    out["resumed"] = {"step": resumed.step, "trainable": trainable(resumed.model)}
    out["writes"] = writes.count

    if rank == 1:
        threading.Thread(target=sigterm_when_armed, daemon=True).start()
    stopped_cfg = tiny_cfg(inp["train_ann"], os.path.join(out_dir, "sigterm"), epochs=50)
    stopped, _ = train_model(stopped_cfg, validate=False, seed=0, device="cpu")
    out["sigterm"] = {"step": stopped.step,
                      "latest": CheckpointManager(stopped_cfg["work_dir"]).latest_epoch()}

    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[2:] == ["slowfast"]:
        torch.set_num_threads(1)
        slowfast_main(sys.argv[1])
    elif sys.argv[2:] == ["omnisource"]:
        torch.set_num_threads(1)
        omnisource_main(sys.argv[1])
    else:
        main(sys.argv[1])
