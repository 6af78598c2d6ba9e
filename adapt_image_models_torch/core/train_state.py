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
``(seed, state.step, 1)``. One device; data parallelism is in ROADMAP
queue 1.
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


def step_generator(seed: int, step: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from (seed, step), and ``stream``
    when it is not 0: the port's ``fold_in(rng, step)``."""
    key = [seed, step] + ([stream] if stream else [])
    entropy = np.random.SeedSequence(key).generate_state(2, np.uint32)
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
                    loss_fn: Optional[Callable] = None,
                    blending: Optional[Callable] = None) -> Callable:
    """Returns ``train_step(state, batch, seed) -> metrics``.

    ``batch``: {'imgs': (B, V, T, H, W, C) uint8 (``prepare_fn`` lays it
    out on the device) or prepared (B[, V], C, T, H, W), 'label': (B,) int
    or (B, C) soft}. Views fold into the batch. ``blending`` (imgs, labels,
    generator) -> (imgs, soft targets) (``data.blending.build_blending``)
    runs before the forward; the accuracies use the hard labels.
    ``loss_fn`` (logits, targets) defaults to hard or soft cross entropy by
    the target's shape.
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
        targets = labels
        if blending is not None:
            imgs, targets = blending(imgs, labels,
                                     step_generator(seed, state.step, "cpu", 1))
        logits = model(imgs, generator=step_generator(seed, state.step, device))
        if loss_fn is not None:
            loss = loss_fn(logits, targets)
        elif targets.dim() == logits.dim():
            loss = soft_cross_entropy(logits, targets)
        else:
            loss = cross_entropy(logits, targets)
        # a trainable tensor the loss does not reach (ViT_CLIP's T_Adapter
        # under shift=True) gets a zero gradient, as jax.grad gives it
        grads = torch.autograd.grad(loss, params, allow_unused=True,
                                    materialize_grads=True)
        grad_norm = global_norm(grads)
        optimizer.update(grads)
        acc_labels = labels if labels.dim() == 1 else labels.argmax(-1)
        top1, top5 = topk_accuracy(logits.detach(), acc_labels)
        state.step += 1
        return {"loss": loss.detach(), "top1_acc": top1, "top5_acc": top5,
                "grad_norm": grad_norm}

    return train_step
