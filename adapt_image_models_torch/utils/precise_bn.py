"""Precise BN: re-estimate the BatchNorm running statistics over training
batches (parity: ``adapt_image_models_tpu/utils/precise_bn.py:18-56``, the
reference's ``mmaction/utils/precise_bn.py``, fvcore style).

After training, running averages lag the final weights; this replaces them
with the mean of the true per-batch moments over up to ``num_iters``
batches. As in the JAX package, no trainer calls it."""

from __future__ import annotations

from typing import Callable, Iterable

import torch
from torch import nn

from adapt_image_models_torch.models.layers import BatchNormFlax


@torch.no_grad()
def compute_precise_bn_stats(model: nn.Module, batches: Iterable, prepare_fn: Callable,
                             num_iters: int = 200) -> nn.Module:
    """For each of up to ``num_iters`` batches (``batch["imgs"]`` through
    ``prepare_fn``; a (B, V, ...) 6-D batch folds its views), one train-mode
    forward whose every BatchNorm keeps that batch's mean and biased
    variance (momentum 0 for the pass, as JAX recovers them from its
    momentum-0.9 update); the buffers end as the mean of those moments. A
    BatchNorm the model keeps in eval mode in training (``norm_eval``,
    frozen stages) keeps its statistics, as JAX's deterministic ones do. The
    parameters are untouched and the model is left in the mode it was in;
    with no batch or no BatchNorm nothing changes. Returns ``model``."""
    norms = [m for m in model.modules() if isinstance(m, BatchNormFlax)]
    if not norms:
        return model
    was_training = model.training
    start = [(m.running_mean.clone(), m.running_var.clone()) for m in norms]
    momenta = [m.momentum for m in norms]
    sums = [(torch.zeros_like(a), torch.zeros_like(b)) for a, b in start]
    device = norms[0].running_mean.device
    generator = torch.Generator(device).manual_seed(0)  # any dropout's draws
    count = 0
    model.train()
    try:
        for m in norms:
            m.momentum = 0.0
        for i, batch in enumerate(batches):
            if i >= num_iters:
                break
            imgs = prepare_fn(batch["imgs"])
            if imgs.dim() == 6:
                imgs = imgs.reshape((-1,) + tuple(imgs.shape[2:]))
            for m, (mean, var) in zip(norms, start):
                m.running_mean.copy_(mean)
                m.running_var.copy_(var)
            model(imgs, generator)
            for m, (sm, sv) in zip(norms, sums):
                sm += m.running_mean
                sv += m.running_var
            count += 1
    finally:
        for m, momentum, (mean, var), (sm, sv) in zip(norms, momenta, start, sums):
            m.momentum = momentum
            m.running_mean.copy_(sm / count if count else mean)
            m.running_var.copy_(sv / count if count else var)
        model.train(was_training)
    return model
