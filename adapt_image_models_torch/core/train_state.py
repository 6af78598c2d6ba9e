"""Train state and train step (parity: ``adapt_image_models_tpu/core/
train_state.py:31-249``).

The JAX package's pytree ``TrainState`` (trainable and frozen params,
optimizer state, step) becomes the model itself, whose parameters carry
``requires_grad`` from the freeze recipe, the port's ``Optimizer`` and a
step count. ``make_train_step`` returns ``train_step(state, batch, seed)``:
forward in train mode, loss, gradients of the trainable parameters only,
the optimizer update and on-device metrics (loss, top1_acc, top5_acc,
grad_norm of the micro-batch gradients). The drop-path and dropout draws
come from a generator seeded from ``(seed, state.step)``, as the JAX step
draws from ``fold_in(rng, step)``. One device; data parallelism is ROADMAP
queue 1 item 8.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import numpy as np
import torch

from adapt_image_models_torch.core.optim import Optimizer, global_norm
from adapt_image_models_torch.models.losses import cross_entropy, soft_cross_entropy


@dataclass
class TrainState:
    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0  # train_step calls (micro-batches), as the JAX state.step


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step): the port's
    ``fold_in(rng, step)``."""
    entropy = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    g = torch.Generator(device=device)
    g.manual_seed(int(entropy[0]) << 32 | int(entropy[1]))
    return g


def topk_accuracy(logits: torch.Tensor, labels: torch.Tensor, topk=(1, 5)):
    """Fraction of rows whose label is among the k highest logits, per k,
    as device tensors."""
    maxk = min(max(topk), logits.shape[-1])
    pred = logits.topk(maxk, dim=-1).indices
    hits = pred == labels[:, None]
    return tuple(hits[:, :min(k, maxk)].any(1).float().mean() for k in topk)


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    prepare_fn: Optional[Callable] = None,
                    loss_fn: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch, seed) -> metrics``.

    ``batch``: {'imgs': (B, V, T, H, W, C) uint8 (``prepare_fn`` lays it
    out on the device) or prepared (B[, V], C, T, H, W), 'label': (B,) int
    or (B, C) soft}. Views fold into the batch. ``loss_fn`` (logits,
    targets) defaults to hard or soft cross entropy by the target's shape.
    """
    params = optimizer.params

    def train_step(state: TrainState, batch: Dict, seed: int) -> Dict[str, torch.Tensor]:
        model.train()
        device = params[0].device
        imgs = batch["imgs"]
        imgs = prepare_fn(imgs) if prepare_fn is not None else imgs.to(device)
        if imgs.dim() == 6:
            imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
        labels = torch.as_tensor(np.asarray(batch["label"])).to(device)
        logits = model(imgs, generator=step_generator(seed, state.step, device))
        if loss_fn is not None:
            loss = loss_fn(logits, labels)
        elif labels.dim() == logits.dim():
            loss = soft_cross_entropy(logits, labels)
        else:
            loss = cross_entropy(logits, labels)
        grads = torch.autograd.grad(loss, params)
        grad_norm = global_norm(grads)
        optimizer.update(grads)
        acc_labels = labels if labels.dim() == 1 else labels.argmax(-1)
        top1, top5 = topk_accuracy(logits.detach(), acc_labels)
        state.step += 1
        return {"loss": loss.detach(), "top1_acc": top1, "top5_acc": top5,
                "grad_norm": grad_norm}

    return train_step
