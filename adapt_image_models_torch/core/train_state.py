"""Train state and train step (parity: ``adapt_image_models_tpu/core/
train_state.py:31-249``).

The JAX package's pytree ``TrainState`` (trainable and frozen params,
optimizer state, step) becomes the model itself, whose parameters carry
``requires_grad`` from the freeze recipe, the port's ``Optimizer`` and a
step count. ``make_train_step`` returns ``train_step(state, batch, seed)``:
the batch blending (``data/blending.py``, after the device prepare, as the
JAX step blends), forward in train mode, loss, gradients of the trainable
parameters only (zeros for one the loss does not reach),
the optimizer update and on-device metrics (loss, top1_acc, top5_acc,
grad_norm of the micro-batch gradients). The drop-path and dropout draws
come from a generator seeded from ``(seed, state.step)``, as the JAX step
draws from ``fold_in(rng, step)``; the blending draws from one seeded from
``(seed, state.step, 1)``. The train-mode forward updates every
BatchNorm's running statistics, once a micro-batch (under
``update_interval`` too), as flax's mutated ``batch_stats`` are (JAX
``core/train_state.py:160-180``); evaluation runs the model in eval mode,
which reads them and updates none. A neck with an aux head (the TPN) adds
its aux CE term, weighted by the neck's ``aux_weight``, to the loss that
is logged and optimised (JAX ``core/train_state.py:104-113, 195-199``): the
model keeps the aux logits of its train-mode forward as ``aux_logits``,
scored against the same targets as the logits (soft CE where the batch is
blended), and the step logs the term as ``aux_loss``.

Under a process group (``parallel/distributed.py``) the step is the JAX
package's ``shard_map`` step (``core/train_state.py:210-232``): each rank
runs it on its shard of the global batch, whose row order is rank-major;
one all_reduce averages the gradients, the loss and the accuracies across
ranks before the gradient norm, the clip and the update, so every rank
applies the same update. Past world size 1 the rank is folded into the
drop-path and dropout generator, as JAX folds ``axis_index``. The blending
runs over the global batch, as JAX blends before ``shard_map``: its λ and
box come from the unfolded generator, the same on every rank, and a row's
partner is the row before it in the global batch, so a rank needs only the
previous rank's last row (``blend_global``). Every rank's micro-batch must
hold as many rows (``apis/train.py`` checks it once, when it builds the
loader). Without a group none of this runs and no collective is called.
"""

from __future__ import annotations

import inspect
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from adapt_image_models_torch.core.optim import Optimizer, global_norm
from adapt_image_models_torch.models.losses import cross_entropy, soft_cross_entropy
from adapt_image_models_torch.parallel.distributed import (
    all_gather_rows, all_reduce_mean_, get_dist_info, is_distributed,
)


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0  # train_step calls (micro-batches), as the JAX state.step


def step_generator(seed: int, step: int, device, stream: int = 0,
                   rank: Optional[int] = None) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step), and ``stream``
    when it is not 0 or a ``rank`` is given, and ``rank``: the port's
    ``fold_in(rng, step)`` (and ``fold_in(., axis_index)``)."""
    key = [seed, step] + ([stream] if stream or rank is not None else [])
    key += [] if rank is None else [rank]
    entropy = np.random.SeedSequence(key).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(entropy[0]) << 32 | int(entropy[1]))
    return g


def drop_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's drop-path and dropout generator: ``step_generator(seed,
    step, device)``, with the rank folded in past world size 1 (JAX folds
    ``axis_index``, ``core/train_state.py:221``; its single-device step
    does not)."""
    rank, world = get_dist_info()
    return step_generator(seed, step, device, rank=rank if world > 1 else None)


def blend_global(blending: Callable, imgs: torch.Tensor, labels: torch.Tensor,
                 generator: torch.Generator):
    """``blending`` of the global batch whose rows ``imgs`` and ``labels``
    are this rank's (rank-major), as (this rank's blended rows, their soft
    targets). Every rank draws from the same ``generator``. A blend pairs
    row i with row i - 1 and works row by row, and neither λ nor the CutMix
    box depends on the batch size: so under a process group a rank blends
    its rows behind the previous rank's last row (rank 0 takes the last
    rank's), which one all_gather of every rank's last image and label, as
    bytes, brings, and drops that row's output."""
    if not is_distributed():
        return blending(imgs, labels, generator)
    rank, world = get_dist_info()
    img, label = imgs[-1:].contiguous(), labels[-1:].contiguous()
    row = torch.cat([img.view(torch.uint8).reshape(-1), label.view(torch.uint8).reshape(-1)])
    prev = all_gather_rows(row[None])[(rank - 1) % world]
    n = img.numel() * img.element_size()
    prev_img = prev[:n].clone().view(img.dtype).view(img.shape)
    prev_label = prev[n:].clone().view(label.dtype).view(label.shape)
    out, targets = blending(torch.cat([prev_img, imgs]), torch.cat([prev_label, labels]),
                            generator)
    return out[1:], targets[1:]


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """Fraction of rows whose label is among the k highest logits, per k,
    as device tensors."""
    maxk = min(max(topk), logits.shape[-1])
    pred = logits.topk(maxk, dim=-1).indices
    hits = pred == labels[:, None]
    return tuple(hits[:, :min(k, maxk)].any(1).float().mean() for k in topk)


def loss_mask_keys(loss_fn: Optional[Callable]) -> tuple:
    """The batch keys among ``mask`` and ``category_mask`` that the custom
    loss's signature names (HVULoss), which the step passes it (JAX
    ``core/train_state.py:115-128``)."""
    if loss_fn is None:
        return ()
    try:
        names = inspect.signature(loss_fn).parameters
    except (TypeError, ValueError):
        return ()
    return tuple(k for k in ("mask", "category_mask") if k in names)


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    prepare_fn: Optional[Callable] = None,
                    loss_fn: Optional[Callable] = None,
                    blending: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch, seed) -> metrics``.

    ``batch``: {'imgs': (B, V, T, H, W, C) uint8 (``prepare_fn`` lays it
    out on the device) or prepared (B[, V], C, T, H, W), 'label': (B,) int
    or (B, C) soft}. Batches of any shape follow each other (OmniSource's
    sources). Views fold into the batch. ``blending`` (imgs, labels,
    generator) -> (imgs, soft targets) (``data.blending.build_blending``)
    runs before the forward, over the global batch (``blend_global``); the
    accuracies use the hard labels. ``loss_fn`` (logits, targets) defaults
    to hard or soft cross entropy by the target's shape; a custom loss whose
    signature names ``mask`` or ``category_mask`` also gets the batch's
    (HVU), and a dict-valued loss is optimised and logged by its
    ``loss_cls`` (JAX ``core/train_state.py:148, 183-190``). Under a process
    group, ``train_step(..., reduce_with=tensors)`` averages these
    one-element tensors across ranks, in place, in the step's one
    all_reduce (the train loop's preemption flag).
    """
    params = optimizer.params
    aux_weight = float(getattr(getattr(model, "neck", None), "aux_weight", 0.0))
    mask_keys = loss_mask_keys(loss_fn)

    def ce(logits, targets):
        return (soft_cross_entropy(logits, targets) if targets.dim() == logits.dim()
                else cross_entropy(logits, targets))

    def train_step(state: TrainState, batch: Dict, seed: int,
                   reduce_with=()) -> Dict[str, torch.Tensor]:
        model.train()
        device = params[0].device
        imgs = batch["imgs"]
        imgs = prepare_fn(imgs) if prepare_fn is not None else imgs.to(device)
        if imgs.dim() == 6:
            imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        labels = torch.as_tensor(np.asarray(batch["label"])).to(device)
        targets = labels
        if blending is not None:
            imgs, targets = blend_global(blending, imgs, labels,
                                         step_generator(seed, state.step, "cpu", 1))
        logits = model(imgs, generator=drop_generator(seed, state.step, device))
        if loss_fn is None:
            loss = ce(logits, targets)
        else:
            loss = loss_fn(logits, targets, **{k: torch.as_tensor(np.asarray(batch[k])).to(device)
                                               for k in mask_keys if k in batch})
            if isinstance(loss, dict):  # HVULoss: the optimised scalar is loss_cls
                loss = loss["loss_cls"]
        aux = {}
        if aux_weight:
            aux["aux_loss"] = ce(model.aux_logits, targets)
            model.aux_logits = None
            loss = loss + aux_weight * aux["aux_loss"]
        # a trainable tensor the loss does not reach (ViT_CLIP's T_Adapter
        # under shift=True) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        loss = loss.detach()
        aux = {k: v.detach() for k, v in aux.items()}
        acc_labels = labels if labels.dim() == 1 else labels.argmax(-1)
        top1, top5 = topk_accuracy(logits.detach(), acc_labels)
        if is_distributed():
            all_reduce_mean_([*grads, loss, top1, top5, *aux.values(), *reduce_with])
        grad_norm = global_norm(grads)
        optimizer.update(grads)
        state.step += 1
        return {"loss": loss, "top1_acc": top1, "top5_acc": top5,
                "grad_norm": grad_norm, **aux}

    return train_step
