"""Model registries (parity: ``adapt_image_models_tpu/models/builder.py``).

The registries use the JAX package's type names, so one config file builds
either package. ``build_model`` returns an ``nn.Module`` whose parameters
live on ``device``; draw its weights with ``model.init_weights(generator)``
or load them with ``convert.load_checkpoint``.
"""

from adapt_image_models_tpu.utils.registry import Registry

BACKBONES = Registry("backbone")
HEADS = Registry("head")
RECOGNIZERS = Registry("recognizer")
LOSSES = Registry("loss")


def build_backbone(cfg, device=None):
    return BACKBONES.build(dict(cfg), device=device)


def build_head(cfg, device=None):
    return HEADS.build(dict(cfg), device=device)


def build_recognizer(cfg, train_cfg=None, test_cfg=None, device=None):
    return RECOGNIZERS.build(dict(cfg), train_cfg=train_cfg, test_cfg=test_cfg,
                             device=device)


def build_loss(cfg):
    return LOSSES.build(dict(cfg))


def build_model(cfg, train_cfg=None, test_cfg=None, device=None):
    """Build a recognizer from its config dict."""
    obj_type = dict(cfg).get("type", "")
    if obj_type in RECOGNIZERS:
        return build_recognizer(cfg, train_cfg=train_cfg, test_cfg=test_cfg,
                                device=device)
    raise KeyError(f"{obj_type} is not a registered recognizer in the port. "
                   f"Available: {sorted(RECOGNIZERS.module_dict)}")
