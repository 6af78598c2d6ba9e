"""Model registries (parity: ``adapt_image_models_tpu/models/builder.py``).

The registries use the JAX package's type names, so one config file builds
either package. ``build_model`` returns an ``nn.Module`` whose parameters
live on ``device``; draw its weights with ``model.init_weights(generator)``
or load them with ``convert.load_checkpoint``.
"""

from adapt_image_models_torch.utils.registry import Registry

BACKBONES = Registry("backbone")
NECKS = Registry("neck")
HEADS = Registry("head")
RECOGNIZERS = Registry("recognizer")
DETECTORS = Registry("detector")
LOSSES = Registry("loss")


def build_backbone(cfg, device=None):
    # 'torchvision.*' / 'timm.*' / 'mmcls.*' types resolve to the port's own
    # backbone (JAX builder.py:18-24)
    from adapt_image_models_torch.models.backbone_sources import resolve_backbone_source
    return BACKBONES.build(resolve_backbone_source(dict(cfg)), device=device)


def build_neck(cfg, device=None):
    return NECKS.build(dict(cfg), device=device)


def build_head(cfg, device=None):
    return HEADS.build(dict(cfg), device=device)


def build_recognizer(cfg, train_cfg=None, test_cfg=None, device=None):
    return RECOGNIZERS.build(dict(cfg), train_cfg=train_cfg, test_cfg=test_cfg,
                             device=device)


def build_detector(cfg, train_cfg=None, test_cfg=None, device=None):
    args = dict(cfg)
    args.setdefault("train_cfg", train_cfg)
    args.setdefault("test_cfg", test_cfg)
    return DETECTORS.build(args, device=device)


def build_loss(cfg):
    return LOSSES.build(dict(cfg))


def build_model(cfg, train_cfg=None, test_cfg=None, device=None):
    """Build a recognizer or a detector from its config dict."""
    obj_type = dict(cfg).get("type", "")
    if obj_type in RECOGNIZERS:
        return build_recognizer(cfg, train_cfg=train_cfg, test_cfg=test_cfg,
                                device=device)
    if obj_type in DETECTORS:
        return build_detector(cfg, train_cfg=train_cfg, test_cfg=test_cfg, device=device)
    raise KeyError(f"{obj_type} is not a registered recognizer or detector in the port. "
                   f"Available: {sorted(RECOGNIZERS.module_dict) + sorted(DETECTORS.module_dict)}")
