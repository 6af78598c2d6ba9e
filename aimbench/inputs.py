"""What a run feeds both sides, drawn from ``--seed``: the weights, on the
device in one call, and the pool of host batches, uint8 clips and int
labels as the port's ``VideoLoader`` yields them (numpy, not pinned)."""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

# streams of one seed
WEIGHTS, CLIPS, LABELS = 1, 2, 3


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one stream of ``seed`` (any whole number)."""
    word = np.random.SeedSequence([int(seed), stream]).generate_state(1, np.uint64)[0]
    return int(word) & (2 ** 63 - 1)


def scale_and_shift(name: str, width: int) -> Tuple[float, float]:
    """A parameter is ``scale * N(0, 1) + shift``: LayerNorm gains about 1,
    the class and position embeddings at CLIP's width**-0.5, everything
    else (the adapters' second projections and every bias too, so that no
    path is the identity) at 0.02."""
    leaf, owner = name.rsplit(".", 1)[-1], name.rsplit(".", 2)[-2]
    if owner.startswith("ln_"):
        return (0.1, 1.0) if leaf == "weight" else (0.02, 0.0)
    if leaf in ("class_embedding", "positional_embedding"):
        return width ** -0.5, 0.0
    return 0.02, 0.0


@torch.no_grad()
def draw_weights(spec: Sequence[Tuple[str, Tuple[int, ...]]], seed: int, width: int,
                 device) -> Dict[str, torch.Tensor]:
    """float32 parameters of ``spec`` on ``device``: one normal draw from a
    generator on the device, cut into the tensors in ``spec``'s order."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, WEIGHTS))
    total = sum(int(np.prod(shape)) for _, shape in spec)
    flat = torch.randn(total, generator=g, device=device, dtype=torch.float32)
    out, at = {}, 0
    for name, shape in spec:
        n = int(np.prod(shape))
        scale, shift = scale_and_shift(name, width)
        out[name] = flat[at:at + n].view(shape).mul(scale).add_(shift)
        at += n
    return out


def draw_pool(seed: int, pool: int, shape: Tuple[int, ...], classes: int, device,
              view_levels: Optional[Sequence[int]] = None) -> List[Dict[str, np.ndarray]]:
    """``pool`` batches {'imgs': uint8 ``shape``, 'label': int64 (B,)}: the
    pixels drawn on the device and brought to the host, the labels by
    numpy; every batch, clip and frame differs. ``view_levels`` ``(lo,
    hi)``: each view of a sample (axis 1) gets a colour of its own, a level
    a channel drawn from ``[lo, hi)``, with pixels within 64 of it, so that
    a sample's views differ as a video's clips do."""
    g = torch.Generator(device=device)
    g.manual_seed(sub_seed(seed, CLIPS))
    rng = np.random.default_rng(sub_seed(seed, LABELS))
    out = []
    for _ in range(pool):
        if view_levels is None:
            imgs = torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
        else:
            lo, hi = (int(v) for v in view_levels)
            if not 64 <= lo < hi <= 192:
                raise ValueError(f"view_levels {view_levels} leave [0, 256)")
            level = torch.randint(lo, hi, shape[:2] + (1,) * (len(shape) - 3) + shape[-1:],
                                  generator=g, device=device, dtype=torch.int16)
            noise = torch.randint(-64, 64, shape, generator=g, device=device, dtype=torch.int16)
            imgs = (noise + level).to(torch.uint8)
        out.append({"imgs": imgs.cpu().numpy(),
                    "label": rng.integers(0, classes, shape[0]).astype(np.int64)})
    return out
