"""Plain PyTorch AIM (Yang et al., ICLR 2023, arXiv:2302.03024): a frozen
CLIP ViT with a temporal, a spatial and a joint adapter in every block, the
I3D head, cross entropy and AdamW. It is the yardstick that a benchmark run
holds the port's output to, so it imports nothing of the port, nor JAX.

Every product is a float32 matrix product with TF32 off (``use_fp32``), or,
for the benchmark's control, one whose operands are first rounded to
float8 e4m3 with a scale a tensor (``fp8=True``). Per block, in the (B*T, N,
D) residual stream of frames:

    x = x + gate_t * T_Adapter(attn_T(ln_1 x))          attention over frames
    x = x + S_Adapter(attn(ln_1 x))                       S_Adapter has a skip
    x = x + mlp(ln_2 x) + gate_j * s * MLP_Adapter(ln_2 x)

An adapter is fc1 -> GELU -> fc2 at a quarter of the width, GELU exact as
published; the MLP's activation is CLIP's QuickGELU. The gates are drop
path: 0 or 1/keep a (clip, frame) row, the rate rising linearly over the
depth. The head averages the frames' class tokens after ``ln_post``, drops
out and projects to the classes. Parameters are a dict named as the port's
``named_parameters`` (and the released AIM checkpoints) name them.

Drop path and dropout are drawn from a generator seeded from (seed, step),
two gates a block in block order, then the head's mask, so that the
reference replays the draws of a train step that uses the same rule
(``drop_generator_seed``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0  # the largest float8 e4m3 value


def use_fp32() -> None:
    """Float32 products in float32: no TF32 in cuBLAS or cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for the tensor (its
    largest magnitude maps to 448), back in float32; the gradient passes
    straight through."""
    amax = x.detach().abs().amax()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    q = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (q - x.detach())


def matmul(a: torch.Tensor, b: torch.Tensor, fp8: bool) -> torch.Tensor:
    if fp8:
        a, b = round_fp8(a), round_fp8(b)
    return a @ b


def linear(x, w, b, fp8):
    """x @ w.T + b, w (out, in) as torch's Linear stores it."""
    return matmul(x, w.t(), fp8) + b


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


def dims(m: dict) -> Tuple[int, int, int, int]:
    """(width, adapter width, tokens a frame, patch size)."""
    d, p = int(m["width"]), int(m["patch_size"])
    return d, int(d * m["adapter_ratio"]), (int(m["input_resolution"]) // p) ** 2 + 1, p


def param_spec(m: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(name, shape) of every parameter, in a fixed order."""
    d, dh, n, p = dims(m)
    spec = [("backbone.conv1.weight", (d, 3, p, p)), ("backbone.class_embedding", (d,)),
            ("backbone.positional_embedding", (n, d)),
            ("backbone.temporal_embedding", (1, int(m["num_frames"]), d)),
            ("backbone.ln_pre.weight", (d,)), ("backbone.ln_pre.bias", (d,))]
    for i in range(int(m["layers"])):
        pre = f"backbone.transformer.resblocks.{i}."
        spec += [(pre + "attn.in_proj_weight", (3 * d, d)), (pre + "attn.in_proj_bias", (3 * d,)),
                 (pre + "attn.out_proj.weight", (d, d)), (pre + "attn.out_proj.bias", (d,)),
                 (pre + "ln_1.weight", (d,)), (pre + "ln_1.bias", (d,)),
                 (pre + "ln_2.weight", (d,)), (pre + "ln_2.bias", (d,)),
                 (pre + "mlp.c_fc.weight", (4 * d, d)), (pre + "mlp.c_fc.bias", (4 * d,)),
                 (pre + "mlp.c_proj.weight", (d, 4 * d)), (pre + "mlp.c_proj.bias", (d,))]
        for a in ("S_Adapter", "T_Adapter", "MLP_Adapter"):
            spec += [(f"{pre}{a}.D_fc1.weight", (dh, d)), (f"{pre}{a}.D_fc1.bias", (dh,)),
                     (f"{pre}{a}.D_fc2.weight", (d, dh)), (f"{pre}{a}.D_fc2.bias", (d,))]
    spec += [("backbone.ln_post.weight", (d,)), ("backbone.ln_post.bias", (d,)),
             ("cls_head.fc_cls.weight", (int(m["num_classes"]), d)),
             ("cls_head.fc_cls.bias", (int(m["num_classes"]),))]
    return spec


def is_trainable(name: str) -> bool:
    """AIM's freeze: only the adapters, the temporal embedding, ln_post and
    the head learn."""
    return (any(k in name for k in ("Adapter", "temporal_embedding", "ln_post"))
            or name.startswith("cls_head."))


def normalize(imgs_uint8: torch.Tensor, mean, std) -> torch.Tensor:
    """(..., T, H, W, C) uint8 -> (..., C, T, H, W) float32, normalised."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=imgs_uint8.device)
    std_t = torch.tensor(std, dtype=torch.float32, device=imgs_uint8.device)
    x = (imgs_uint8.float() - mean_t) / std_t
    n = x.dim()
    return x.permute(*range(n - 4), n - 1, n - 4, n - 3, n - 2)


def _attention(x, P, pre, heads, fp8, frames=None):
    bt, n, d = x.shape
    hd = d // heads
    q, k, v = linear(x, P[pre + "in_proj_weight"], P[pre + "in_proj_bias"], fp8).chunk(3, -1)
    if frames is None:  # over the tokens of a frame
        split = lambda u: u.reshape(bt, n, heads, hd).transpose(1, 2)  # noqa: E731
    else:  # over the frames of a clip, token by token
        split = lambda u: u.reshape(bt // frames, frames, n, heads, hd).permute(0, 2, 3, 1, 4)  # noqa: E731
    q, k, v = split(q), split(k), split(v)
    p = torch.softmax(matmul(q * hd ** -0.5, k.transpose(-1, -2), fp8), dim=-1)
    o = matmul(p, v, fp8)
    o = o.transpose(1, 2) if frames is None else o.permute(0, 3, 1, 2, 4)
    return linear(o.reshape(bt, n, d), P[pre + "out_proj.weight"], P[pre + "out_proj.bias"], fp8)


def _adapter(x, P, pre, skip, fp8):
    h = F.gelu(linear(x, P[pre + "D_fc1.weight"], P[pre + "D_fc1.bias"], fp8))
    y = linear(h, P[pre + "D_fc2.weight"], P[pre + "D_fc2.bias"], fp8)
    return x + y if skip else y


def _ln(x, P, pre, eps=1e-5):
    return F.layer_norm(x, (x.shape[-1],), P[pre + "weight"], P[pre + "bias"], eps)


def _gated(y, gate):
    return y if gate is None else y * gate[:, None, None]


def _block(x, gate_t, gate_j, P, i, m, fp8):
    pre = f"backbone.transformer.resblocks.{i}."
    heads, t = int(m["heads"]), int(m["num_frames"])
    xt = _adapter(_attention(_ln(x, P, pre + "ln_1."), P, pre + "attn.", heads, fp8, t),
                  P, pre + "T_Adapter.", False, fp8)
    x = x + _gated(xt, gate_t)
    x = x + _adapter(_attention(_ln(x, P, pre + "ln_1."), P, pre + "attn.", heads, fp8),
                     P, pre + "S_Adapter.", True, fp8)
    xn = _ln(x, P, pre + "ln_2.")
    mlp = linear(quick_gelu(linear(xn, P[pre + "mlp.c_fc.weight"], P[pre + "mlp.c_fc.bias"], fp8)),
                 P[pre + "mlp.c_proj.weight"], P[pre + "mlp.c_proj.bias"], fp8)
    side = float(m["adapter_scale"]) * _adapter(xn, P, pre + "MLP_Adapter.", False, fp8)
    return x + mlp + _gated(side, gate_j)


def forward(P: Dict[str, torch.Tensor], x: torch.Tensor, m: dict,
            gates: Optional[Sequence] = None, head_mask: Optional[torch.Tensor] = None,
            fp8: bool = False, recompute: bool = False) -> torch.Tensor:
    """(B, 3, T, H, W) float32 clips -> (B, classes) logits. ``gates``: a
    (gate_t, gate_j) pair of (B*T,) tensors a block (train mode);
    ``head_mask``: the head's (B, D) dropout mask; ``recompute``: keep
    only each block's input for the backward."""
    b, c, t, h, w = x.shape
    d, _, n, p = dims(m)
    patches = (x.permute(0, 2, 1, 3, 4).reshape(b * t, c, h // p, p, w // p, p)
               .permute(0, 2, 4, 1, 3, 5).reshape(b * t, (h // p) * (w // p), c * p * p))
    emb = matmul(patches, P["backbone.conv1.weight"].reshape(d, c * p * p).t(), fp8)
    cls = P["backbone.class_embedding"].expand(b * t, 1, d)
    z = torch.cat([cls, emb], 1) + P["backbone.positional_embedding"]
    z = (z.reshape(b, t, n, d) + P["backbone.temporal_embedding"][:, :, None, :]).reshape(b * t, n, d)
    z = _ln(z, P, "backbone.ln_pre.")
    for i in range(int(m["layers"])):
        g_t, g_j = gates[i] if gates is not None else (None, None)
        if recompute and torch.is_grad_enabled():
            z = checkpoint(_block, z, g_t, g_j, P, i, m, fp8, use_reentrant=False)
        else:
            z = _block(z, g_t, g_j, P, i, m, fp8)
    feat = _ln(z[:, 0], P, "backbone.ln_post.").reshape(b, t, d).mean(1)
    if head_mask is not None:
        keep = 1.0 - float(m["dropout_ratio"])
        feat = torch.where(head_mask, feat / keep, torch.zeros_like(feat))
    return matmul(feat, P["cls_head.fc_cls.weight"].t(), fp8) + P["cls_head.fc_cls.bias"]


# ---------------------------------------------------------------------------
# drop path and dropout draws


def drop_generator_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s drop-path and dropout generator: the two
    32-bit words numpy's SeedSequence((seed, step)) gives first."""
    e = np.random.SeedSequence([int(seed), int(step)]).generate_state(2, np.uint32)
    return int(e[0]) << 32 | int(e[1])


def draw_masks(seed: int, step: int, clips: int, m: dict, device):
    """(gates, head_mask) of one train step over ``clips`` clips: per block
    the temporal then the joint gate, 0 or 1/keep a (clip, frame) row at the
    block's rate (``linspace(0, drop_path_rate, layers)`` in float32), then
    the head's (clips, D) keep mask."""
    g = torch.Generator(device=device)
    g.manual_seed(drop_generator_seed(seed, step))
    rows = clips * int(m["num_frames"])
    rates = np.linspace(0.0, float(m["drop_path_rate"]), int(m["layers"]), dtype=np.float32)
    gates = []
    for rate in rates:
        keep = np.float32(1.0 - float(rate))
        pair = tuple((torch.rand((rows,), generator=g, device=device) < keep).float() / float(keep)
                     for _ in range(2))
        gates.append(pair)
    keep = 1.0 - float(m["dropout_ratio"])
    head = torch.rand((clips, int(m["width"])), generator=g, device=device) < keep
    return gates, head


# ---------------------------------------------------------------------------
# training: cross entropy, AdamW, the learning-rate schedule


def learning_rate(sched: dict, base_lr: float, update: int) -> float:
    """mmcv's CosineAnnealing to ``min_lr`` over the run with a linear
    warm-up by epoch from ``warmup_ratio``, at optimizer update ``update``
    (from 0)."""
    spe = int(sched["steps_per_epoch"])
    total = int(sched["total_epochs"]) * spe
    warm = int(float(sched["warmup_epochs"]) * spe)
    lo = float(sched["min_lr"])
    progress = min(max(update / max(total, 1), 0.0), 1.0)
    lr = lo + 0.5 * (base_lr - lo) * (1.0 + math.cos(math.pi * progress))
    if warm > 0 and update < warm:
        frac = min(max(update / warm, 0.0), 1.0)
        lr *= 1.0 - (1.0 - frac) * (1.0 - float(sched["warmup_ratio"]))
    return lr


class Trainer:
    """The reference's train step: cross entropy over the batch, the
    gradients of the trainable tensors, AdamW with the decay and learning
    rate each tensor's name gives. ``chunk`` clips go through the model at
    a time and their gradients add up (each clip's loss is its share of the
    batch mean); ``recompute`` keeps only the blocks' inputs; ``lr_scale``
    multiplies every learning rate (a fault the benchmark plants)."""

    def __init__(self, P: Dict[str, torch.Tensor], cfg: dict, fp8: bool = False,
                 chunk: int = 8, recompute: bool = True, lr_scale: float = 1.0):
        self.P, self.m, self.fp8, self.lr_scale = P, cfg["model"], fp8, float(lr_scale)
        self.opt, self.sched = cfg["optimizer"], cfg["schedule"]
        self.mean, self.std = cfg["mean"], cfg["std"]
        self.chunk, self.recompute = int(chunk), recompute
        self.names = [n for n, _ in param_spec(self.m) if is_trainable(n)]
        for name, p in P.items():
            p.requires_grad_(name in self.names)
        self.exp_avg = {n: torch.zeros_like(P[n]) for n in self.names}
        self.exp_avg_sq = {n: torch.zeros_like(P[n]) for n in self.names}
        self.updates = 0

    def decays(self, name: str) -> bool:
        return not any(k in name for k in self.opt["no_decay_substrings"])

    def lr_mult(self, name: str) -> float:
        return next((float(v) for k, v in self.opt["lr_mult_prefixes"].items()
                     if name.startswith(k)), 1.0)

    def gradients(self, imgs_uint8: torch.Tensor, labels: torch.Tensor, seed: int,
                  step: int, rows: Optional[int] = None):
        """(loss, {name: gradient}) of one batch; ``rows`` keeps the first
        rows of the batch alone (a fault the benchmark's tests plant)."""
        clips = imgs_uint8.shape[0]
        gates, head = draw_masks(seed, step, clips, self.m, imgs_uint8.device)
        rows = clips if rows is None else rows
        t = int(self.m["num_frames"])
        params = [self.P[n] for n in self.names]
        grads = [torch.zeros_like(p) for p in params]
        loss = torch.zeros((), device=imgs_uint8.device)
        for c0 in range(0, rows, self.chunk):
            c1 = min(c0 + self.chunk, rows)
            x = normalize(imgs_uint8[c0:c1, 0] if imgs_uint8.dim() == 6 else imgs_uint8[c0:c1],
                          self.mean, self.std)
            g = [(a[c0 * t:c1 * t], b[c0 * t:c1 * t]) for a, b in gates]
            logits = forward(self.P, x, self.m, g, head[c0:c1], self.fp8, self.recompute)
            part = F.cross_entropy(logits, labels[c0:c1], reduction="sum") / rows
            for acc, gr in zip(grads, torch.autograd.grad(part, params)):
                acc.add_(gr)
            loss += part.detach()
        return float(loss), dict(zip(self.names, grads))

    @torch.no_grad()
    def update(self, grads: Dict[str, torch.Tensor]) -> None:
        """One AdamW update (torch's arithmetic): decay ``p *= 1 - lr wd``,
        then ``p -= lr / bc1 * m / (sqrt(v) / sqrt(bc2) + eps)``."""
        b1, b2 = (float(b) for b in self.opt["betas"])
        eps, wd = float(self.opt["eps"]), float(self.opt["weight_decay"])
        base = learning_rate(self.sched, float(self.opt["lr"]), self.updates) * self.lr_scale
        self.updates += 1
        t = self.updates
        for n in self.names:
            p, g = self.P[n], grads[n]
            lr = base * self.lr_mult(n)
            m, v = self.exp_avg[n], self.exp_avg_sq[n]
            m.lerp_(g, 1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            if self.decays(n):
                p.mul_(1 - lr * wd)
            denom = (v.sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1 ** t))

    def step(self, imgs_uint8, labels, seed, step, rows=None):
        loss, grads = self.gradients(imgs_uint8, labels, seed, step, rows)
        self.update(grads)
        return loss, grads


@torch.no_grad()
def eval_scores(P: Dict[str, torch.Tensor], imgs_uint8: torch.Tensor, cfg: dict, views: int,
                fp8: bool = False, chunk: int = 16, kept: Optional[int] = None) -> torch.Tensor:
    """(B, V, T, H, W, C) uint8 -> (B, classes) float32: each view's
    softmax, averaged over the views (over the first ``kept`` alone: a
    fault the benchmark plants)."""
    b = imgs_uint8.shape[0]
    flat = imgs_uint8.reshape((b * views,) + tuple(imgs_uint8.shape[2:]))
    probs = []
    for c0 in range(0, flat.shape[0], chunk):
        x = normalize(flat[c0:c0 + chunk], cfg["mean"], cfg["std"])
        probs.append(torch.softmax(forward(P, x, cfg["model"], fp8=fp8), dim=-1))
    return torch.cat(probs).reshape(b, views, -1)[:, :kept].mean(1)
