"""The work a cell requires, counted from the configuration's shapes: two
operations a multiply-add of every matrix product (attention's QK^T and PV
included), nothing elementwise. The peak it is held to is one H100's dense
bf16 rate."""

from __future__ import annotations

PEAK_FLOPS = 989e12  # one H100 SXM, dense bf16 (NVIDIA's data sheet)


def _sizes(m: dict):
    d, p = int(m["width"]), int(m["patch_size"])
    n = (int(m["input_resolution"]) // p) ** 2 + 1
    return d, int(d * m["adapter_ratio"]), n, p, int(m["num_frames"]), int(m["layers"])


def forward_macs(m: dict) -> dict:
    """Multiply-adds of one clip's forward, by part: ``dense`` the blocks'
    CLIP projections, ``adapters`` the three adapters' two projections,
    ``attention`` QK^T and PV over tokens and over frames, ``embed`` the
    patch projection, ``head`` the classifier."""
    d, dh, n, p, t, layers = _sizes(m)
    frames = t * layers  # (frame, block) pairs
    return {
        "dense": frames * n * d * d * (3 + 1 + 3 + 1 + 8),  # qkv, out twice; fc, proj
        "adapters": frames * 3 * 2 * n * d * dh,
        "attention": frames * (2 * n * n * d + 2 * n * t * d),
        "embed": t * (n - 1) * 3 * p * p * d,
        "head": d * int(m["num_classes"]),
    }


def forward_flops(m: dict) -> int:
    """Operations of one clip's forward."""
    return 2 * sum(forward_macs(m).values())


def train_flops(m: dict) -> int:
    """Operations one clip's train step requires: the forward; the input
    cotangent through every block's products (attention's two products
    give four: dQ, dK, dP, dV) down to the temporal embedding, the first
    trainable tensor, so not through the patch projection; the weight
    cotangents of the adapters and the head. A recomputed forward is not
    counted."""
    f = forward_macs(m)
    backward = (f["dense"] + f["adapters"] + 2 * f["attention"]  # input cotangents
                + f["adapters"]                                  # adapter weights
                + 2 * f["head"])                                 # head: dX and dW
    return 2 * (sum(f.values()) + backward)
