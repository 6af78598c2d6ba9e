"""FLOP and parameter counts of a recognizer (the port's counterpart of the
XLA cost analysis of ``tools/analysis/get_flops.py``).

``torch.utils.flop_counter.FlopCounterMode`` counts the convolutions and
matrix products, two operations a multiply-add. The port's kernels are
registered ops with FLOP formulas (``ops/_kernels.py``), so a count over
the kernel route of ``attention_core="fused"`` equals one over the plain
route. On the meta device nothing is computed; on CUDA the kernels run.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch import nn

from adapt_image_models_torch.parallel.partition import is_trainable_name


def count_flops(model: nn.Module, shape: Sequence[int], device="meta") -> int:
    """Operations of one forward of ``model`` (on ``device``) on a zero
    input of ``shape``."""
    from torch.utils.flop_counter import FlopCounterMode
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        model(torch.zeros(*shape, device=device))
    return counter.get_total_flops()


def count_params(model: nn.Module) -> Tuple[int, int, int]:
    """(total, tunable, frozen) parameter counts by the AIM freeze
    (``parallel.partition.freeze_params``: a model with adapters trains its
    adapters, temporal embedding, ``ln_post`` and head; one without trains
    everything), without changing ``requires_grad``."""
    named = list(model.named_parameters())
    freeze_backbone = any("Adapter" in n for n, _ in named)
    total = sum(p.numel() for _, p in named)
    tunable = sum(p.numel() for n, p in named
                  if not freeze_backbone or is_trainable_name(n))
    return total, tunable, total - tunable


def view_gflop(cfg: Dict[str, Any], split: str = "test") -> float:
    """GFLOP of one view of ``split``'s pipeline through the recognizer of
    ``cfg`` (convolutions and matmuls on the meta device: no compute): a 3D
    recipe's clip, a 2D recipe's crop of its sampled segments, an audio
    recipe's spectrogram segment."""
    from adapt_image_models_torch.apis import model_config
    from adapt_image_models_torch.apis.inference import sample_shape
    from adapt_image_models_torch.models import build_model
    mcfg = {k: v for k, v in model_config(cfg, split).items()
            if k not in ("test_cfg", "train_cfg")}
    model = build_model(mcfg, device="meta").eval()
    shape = sample_shape(cfg["data"][split]["pipeline"])
    views = shape[1] if mcfg["type"] == "AudioRecognizer" else 1
    return count_flops(model, shape) / 1e9 / views
