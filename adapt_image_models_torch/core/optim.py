"""Optimizer with mmcv ``paramwise_cfg`` semantics (parity:
``adapt_image_models_tpu/core/optim.py:51-108``).

The reference recipe (``vitclip_base_k400.py``) is AdamW with
``custom_keys`` that zero the weight decay of embeddings and LayerNorms
(ViT-L adds ``lr_mult=0.1`` on the backbone). Keys match parameter-name
substrings, the longest match winning, as mmcv's constructor sorts them;
``DEFAULT_NO_DECAY_KEYS`` also skip decay, as in the JAX package. Each
(decay, lr_mult) pair becomes a torch param group. The JAX package's optax
chain becomes:

* ``grad_clip``: the gradients are scaled to a global norm of at most
  ``max_norm`` before the update (``optax.clip_by_global_norm``);
* ``update_interval``: gradients of that many micro-batches are averaged
  and applied once (``optax.MultiSteps``, the reference's
  ``DistOptimizerHook.update_interval``);
* the learning rate of update k (from 0) is ``schedule(k) * lr_mult``,
  which is what ``optax.adamw(learning_rate=schedule)`` reads.

torch's AdamW decays ``p *= 1 - lr * wd`` before the Adam step, optax adds
``wd * p`` to the Adam direction; both subtract ``lr * (adam + wd * p)``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch

DEFAULT_NO_DECAY_KEYS = ("class_embedding", "positional_embedding",
                         "temporal_embedding", "ln_1", "ln_2", "ln_pre",
                         "ln_post", "bias")


# the JAX package's parameter tree names the recognizer's two sub-modules
# otherwise, and the shared configs' custom_keys are written against its
# names (``vitclip_large_k400.py`` puts lr_mult=0.1 on ``backbone_module``)
_JAX_ROOTS = {"backbone": "backbone_module", "cls_head": "head_module"}


def match_custom_keys(name: str, custom_keys: Dict[str, Dict[str, float]],
                      field: str, default: float) -> float:
    """Longest-substring match wins. A key matches a parameter's name in
    this package (``backbone.ln_post.weight``) or its name with the JAX
    package's root (``backbone_module.ln_post.weight``), so that one config
    gives both packages the same multipliers."""
    root, _, rest = name.partition(".")
    alias = f"{_JAX_ROOTS[root]}.{rest}" if root in _JAX_ROOTS else name
    best, best_len = default, -1
    for key, mults in custom_keys.items():
        if ((key in name or key in alias) and len(key) > best_len
                and field in mults):
            best, best_len = mults[field], len(key)
    return best


def param_settings(name: str, paramwise_cfg: Optional[dict]) -> Tuple[bool, float]:
    """(decays, lr_mult) of one parameter name."""
    custom_keys = (paramwise_cfg or {}).get("custom_keys", {})
    decay_mult = match_custom_keys(name, custom_keys, "decay_mult", 1.0)
    if decay_mult == 1.0 and any(k in name for k in DEFAULT_NO_DECAY_KEYS):
        decay_mult = 0.0
    return decay_mult > 0.0, match_custom_keys(name, custom_keys, "lr_mult", 1.0)


class Optimizer:
    """AdamW over named parameters, with the schedule, global-norm
    clipping and micro-batch accumulation applied around ``torch.optim``.
    Call ``update(grads)`` once per micro-batch with the gradients of
    ``params`` (in order); it returns True when it stepped."""

    def __init__(self, optimizer_cfg: dict, named_params: Sequence[Tuple[str, torch.nn.Parameter]],
                 schedule: Union[float, Callable[[int], float]],
                 grad_clip: Optional[float] = None, update_interval: int = 1):
        cfg = dict(optimizer_cfg)
        opt_type = cfg.pop("type", "AdamW")
        if opt_type != "AdamW":
            raise KeyError(f"unsupported optimizer type {opt_type} (the port "
                           "has AdamW, which every AIM recipe uses)")
        paramwise = cfg.pop("paramwise_cfg", None)
        weight_decay = cfg.pop("weight_decay", 0.0)
        self.params = [p for _, p in named_params]
        self.schedule = schedule if callable(schedule) else (lambda _, lr=schedule: lr)
        self.grad_clip = grad_clip
        self.update_interval = int(update_interval)
        self.updates = 0  # optimizer steps taken
        self.micro = 0    # micro-batches accumulated toward the next step
        self._acc: Optional[List[torch.Tensor]] = None

        groups: Dict[Tuple[bool, float], dict] = {}
        for name, p in named_params:
            decays, lr_mult = param_settings(name, paramwise)
            group = groups.setdefault((decays, lr_mult), {
                "params": [], "names": [], "lr_mult": lr_mult,
                "weight_decay": weight_decay if decays else 0.0})
            group["params"].append(p)
            group["names"].append(name)
        self.torch = torch.optim.AdamW(list(groups.values()), lr=0.0,
                                       betas=tuple(cfg.pop("betas", (0.9, 0.999))),
                                       eps=cfg.pop("eps", 1e-8))

    @property
    def param_groups(self):
        return self.torch.param_groups

    def lr(self) -> float:
        """The base learning rate of the next update."""
        return float(self.schedule(self.updates))

    def update(self, grads: Sequence[torch.Tensor]) -> bool:
        grads = list(grads)
        if self.update_interval > 1:
            if self._acc is None:
                self._acc = [g.detach().clone() for g in grads]
            else:
                for a, g in zip(self._acc, grads):
                    a.add_(g)
            self.micro += 1
            if self.micro < self.update_interval:
                return False
            grads = [a / self.update_interval for a in self._acc]
            self._acc, self.micro = None, 0
        if self.grad_clip:
            norm = global_norm(grads)
            factor = torch.where(norm < self.grad_clip, 1.0, self.grad_clip / norm)
            grads = [g * factor for g in grads]
        for p, g in zip(self.params, grads):
            p.grad = g.to(p.dtype)
        base = self.lr()
        for group in self.torch.param_groups:
            group["lr"] = base * group["lr_mult"]
        self.torch.step()
        for p in self.params:
            p.grad = None
        self.updates += 1
        return True

    def state_dict(self) -> dict:
        return {"torch": self.torch.state_dict(), "updates": self.updates,
                "micro": self.micro, "acc": self._acc}

    def load_state_dict(self, state: dict) -> None:
        self.torch.load_state_dict(state["torch"])
        self.updates, self.micro = int(state["updates"]), int(state["micro"])
        acc = state.get("acc")
        self._acc = None if acc is None else [
            a.to(p.device) for a, p in zip(acc, self.params)]


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in fp32, on device."""
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def build_optimizer(optimizer_cfg: dict, model: torch.nn.Module, schedule,
                    grad_clip: Optional[float] = None,
                    update_interval: int = 1) -> Optimizer:
    """An ``Optimizer`` over the parameters of ``model`` that require grad."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    return Optimizer(optimizer_cfg, named, schedule, grad_clip, update_interval)
