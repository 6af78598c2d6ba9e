"""SlowFast and X3D of the PyTorch port against the JAX package, with
their heads, and the I3D head's (B, D) input.

The same seeded numpy inputs and weights go through both packages (JAX
``variables`` through ``params_from_jax``, loaded strictly). Toy geometry:
SlowFast at base width 16 (the Fast pathway 2 channels wide) with a deeper
Slow than Fast pathway, alpha 4 on 8 frames and alpha 8 on 16, where the
laterals pad T by (0, 1) and by (0, 0); X3D at base width 8, two blocks a
stage (squeeze-excite on every other, counted across stages), the stride-2
depthwise convs on even sizes; 2 clips at 32² (SlowFast at alpha 8 at 48²,
where its Slow stage 4 still has 8 positions a clip). Each recognizer case holds
the eval forward to JAX and the train mode to the port's float64
evaluation (``tests/test_torch_resnet3d.py::assert_train_mode_close``).

Tolerances: eval logits and maps 2e-5 of their largest magnitude (the
CPU reading in ``tests/test_torch_resnet3d.py``'s docstring covers these
cases); every head on (B, D) bit-equal; train mode as
``tests/test_torch_resnet3d.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from adapt_image_models_tpu.models.builder import HEADS as JAX_HEADS
from adapt_image_models_torch.models.builder import build_head

from share_cores import share_cores  # noqa: F401 (autouse: the worker's share of the cores)
from test_torch_resnet2d import _clips, _np, _rel, jax_variables
from test_torch_resnet3d import (
    CLASSES, assert_train_mode_close, backbone_pair, port_model,
)


def slowfast_cfg(alpha, **backbone):
    bb = dict(type="ResNet3dSlowFast", alpha=alpha, base_channels=16, stage_blocks=(1, 1, 1, 1),
              slow_stage_blocks=(1, 2, 1, 1), **backbone)
    return dict(type="Recognizer3D", backbone=bb,
                cls_head=dict(type="SlowFastHead", num_classes=CLASSES, in_channels=512 + 64,
                              dropout_ratio=0.0))


def x3d_cfg(in_channels=144, **backbone):
    bb = dict(type="X3D", base_channels=8, stage_blocks=(1, 1, 1, 1), gamma_d=1.5, **backbone)
    return dict(type="Recognizer3D", backbone=bb,
                cls_head=dict(type="X3DHead", num_classes=CLASSES, in_channels=in_channels,
                              mid_channels=32, dropout_ratio=0.0))


CASES = {
    "slowfast_alpha4": (slowfast_cfg(4), (2, 3, 8, 32, 32)),
    "slowfast_alpha8": (slowfast_cfg(8, fast_stage_blocks=(1, 1, 2, 1)), (2, 3, 16, 48, 48)),
    "x3d": (x3d_cfg(), (2, 3, 4, 32, 32)),
    # round_width(8, 2) = 16 wide, conv5 to int(128 · 1.5) = 192
    "x3d_wide": (x3d_cfg(192, gamma_w=2.0, gamma_b=1.5), (2, 3, 4, 40, 40)),
}


@pytest.mark.parametrize("name", list(CASES))
def test_recognizer_matches_jax(name):
    """The eval forward against JAX (2e-5), then the train-mode forward,
    running statistics and gradients against the float64 arbiter."""
    cfg, shape = CASES[name]
    jmodel, variables = jax_variables(cfg, shape)
    model = port_model(cfg, variables).eval()
    x = _clips(shape, 5)
    with torch.no_grad():
        assert _rel(model(torch.tensor(x)), jax.jit(jmodel.apply)(variables, jnp.asarray(x))) < 2e-5
    assert_train_mode_close(cfg, {}, variables, jmodel, x)


@pytest.mark.parametrize("alpha,frames", [(4, 8), (8, 16)])
def test_slowfast_pathways_match_jax(alpha, frames):
    """The two pathways' channels-last maps (Slow at T / alpha frames,
    Fast at T) against JAX's; a T that alpha does not divide raises
    ValueError, as in JAX."""
    bb = slowfast_cfg(alpha)["backbone"]
    shape = (2, 3, frames, 32, 32)
    jbb, bvars, port = backbone_pair(bb, shape)
    x = _clips(shape, 6)
    with torch.no_grad():
        slow, fast = port(torch.tensor(x))
    jslow, jfast = jbb.apply(bvars, jnp.asarray(x))
    assert slow.shape == (2, frames // alpha, 1, 1, 512) and fast.shape == (2, frames, 1, 1, 64)
    assert _rel(slow, jslow) < 2e-5 and _rel(fast, jfast) < 2e-5
    # Slow stage 1's 64 channels and lateral 1's twice Fast stage 1's 8
    assert port.slow_path.layer2[0].conv1.in_channels == 64 + 2 * 8
    with pytest.raises(ValueError):
        port(torch.zeros(1, 3, frames + 1, 32, 32))


def test_x3d_blocks_follow_jax():
    """X3D-M's shape as shipped: round_width, ceil(depth · gamma_d) blocks a
    stage (3, 5, 11, 7), squeeze-excite on every other block counted
    across stages, conv5 to 432 channels; the depthwise convs' groups."""
    from adapt_image_models_torch.models.builder import build_backbone
    bb = build_backbone(dict(type="X3D", gamma_w=1.0, gamma_b=2.25, gamma_d=2.2),
                        device="meta")
    depths = [len(getattr(bb, f"stage{i}")) for i in range(1, 5)]
    assert depths == [3, 5, 11, 7]
    se = [blk.se is not None for i in range(1, 5) for blk in getattr(bb, f"stage{i}")]
    assert se == [k % 2 == 0 for k in range(sum(depths))]
    assert bb.conv5.out_channels == 432 and bb.conv1_t.groups == 24
    assert bb.stage3[0].conv2.groups == 216 and bb.stage3[0].se.fc1.out_features == 13


@pytest.mark.parametrize("head", ["SlowFastHead", "X3DHead", "I3DHead"])
@pytest.mark.parametrize("features", ["maps", "vector"])
def test_heads_match_jax(head, features):
    """Each head on channels-last maps (SlowFast on a tuple of two) and on
    (B, D) features against JAX's, with the same fc weights; on (B, D)
    each is bit-equal to JAX's. The I3D head on (B, D) is C3D's: before the
    repair of its pool, torch's mean over an empty dim tuple reduced the
    batch to a scalar."""
    rng = np.random.default_rng(11)
    # (B, D): small integers, whose products and sums are exact in fp32 in
    # any order, so the two packages' matmuls agree bit for bit
    draw = rng.standard_normal if features == "maps" else (lambda s: rng.integers(-4, 5, s))
    if features == "maps":
        x = ((draw((2, 2, 3, 3, 24)), draw((2, 8, 3, 3, 8)))
             if head == "SlowFastHead" else (draw((2, 4, 3, 3, 32)),))
    else:
        x = (draw((3, 32)),)
    x = tuple(a.astype(np.float32) for a in x)
    cfg = dict(type=head, num_classes=CLASSES, in_channels=32, dropout_ratio=0.0)
    if head == "X3DHead":
        cfg["mid_channels"] = 16
    jhead = JAX_HEADS.build(dict(cfg))
    jx = tuple(jnp.asarray(a) for a in x) if head == "SlowFastHead" else jnp.asarray(x[0])
    variables = jhead.init(jax.random.PRNGKey(0), jx)
    rng_w = np.random.default_rng(12)
    params = jax.tree_util.tree_map(
        lambda a: (rng_w.standard_normal(a.shape) if features == "maps"
                   else rng_w.integers(-4, 5, a.shape)).astype(np.float32), variables["params"])
    want = jhead.apply({"params": params}, jx)
    port = build_head(cfg).eval()
    with torch.no_grad():
        for name, p in params.items():
            getattr(port, name).weight.copy_(torch.tensor(np.asarray(p["kernel"]).T))
            getattr(port, name).bias.copy_(torch.tensor(np.asarray(p["bias"])))
        tx = tuple(torch.tensor(a) for a in x)
        got = port(tx if head == "SlowFastHead" else tx[0])
    assert got.shape == (x[0].shape[0], CLASSES)
    if features == "vector":
        np.testing.assert_array_equal(got.numpy(), _np(want))
    else:
        assert _rel(got, want) < 2e-5


def test_heads_dropout_draws_in_train_mode():
    """Dropout only in train mode, drawn from the caller's generator: the
    same seed gives the same logits, eval mode none."""
    for head in (build_head(dict(type="SlowFastHead", num_classes=3, in_channels=8)),
                 build_head(dict(type="X3DHead", num_classes=3, in_channels=8, mid_channels=4))):
        head.init_weights(torch.Generator().manual_seed(0))
        x = torch.randn(4, 2, 2, 2, 8)
        head.train()
        a = head(x, torch.Generator().manual_seed(1))
        b = head(x, torch.Generator().manual_seed(1))
        assert torch.equal(a, b)
        head.eval()
        assert torch.equal(head(x), head(x))
