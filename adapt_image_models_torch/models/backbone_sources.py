"""Third-party backbone-source prefixes: ``torchvision.*``, ``timm.*`` and
``mmcls.*`` (parity: ``adapt_image_models_tpu/models/backbone_sources.py``).

The reference recognizer builds a backbone whose ``type`` carries a source
prefix from that library. The JAX package, and the port with it, resolves
each known name to its own registered backbone with the architecture's
hyper-parameters, which keeps the ``(B·S, C, H, W) -> (B·S, C_out)``
contract of ``Recognizer2D``. ``pretrained=True`` (a torch-hub download)
is refused: there is no network, and a silent random
initialisation would be a trap.
"""

from typing import Any, Dict

# torchvision model name -> (registered type, arch kwargs)
_TORCHVISION = {
    "resnet18": ("ResNet", dict(depth=18)),
    "resnet34": ("ResNet", dict(depth=34)),
    "resnet50": ("ResNet", dict(depth=50)),
    "resnet101": ("ResNet", dict(depth=101)),
    "resnet152": ("ResNet", dict(depth=152)),
    "mobilenet_v2": ("MobileNetV2", dict()),
    "densenet121": ("DenseNet", dict(depth=121)),
    "densenet161": ("DenseNet", dict(depth=161)),
    "densenet169": ("DenseNet", dict(depth=169)),
    "densenet201": ("DenseNet", dict(depth=201)),
    "resnext101_32x8d": ("ResNeXt", dict(depth=101, groups=32, width_per_group=8)),
    "resnext50_32x4d": ("ResNeXt", dict(depth=50, groups=32, width_per_group=4)),
}

# timm model name -> (registered type, arch kwargs)
_TIMM = {
    "swin_tiny_patch4_window7_224": (
        "SwinTransformer2D",
        dict(patch_size=4, embed_dim=96, depths=(2, 2, 6, 2),
             num_heads=(3, 6, 12, 24), window_size=7)),
    "swin_small_patch4_window7_224": (
        "SwinTransformer2D",
        dict(patch_size=4, embed_dim=96, depths=(2, 2, 18, 2),
             num_heads=(3, 6, 12, 24), window_size=7)),
    "swin_base_patch4_window7_224": (
        "SwinTransformer2D",
        dict(patch_size=4, embed_dim=128, depths=(2, 2, 18, 2),
             num_heads=(4, 8, 16, 32), window_size=7)),
}


def resolve_backbone_source(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """A source-prefixed backbone config rewritten to the port's own type;
    ``cfg`` unchanged when its type has no source prefix. Raises
    ``KeyError`` (listing the supported names) for an unknown prefixed
    name and ``ValueError`` for ``pretrained=True``."""
    obj_type = cfg.get("type", "")
    if "." not in obj_type:
        return cfg
    source, name = obj_type.split(".", 1)
    if source not in ("torchvision", "timm", "mmcls"):
        return cfg
    cfg = dict(cfg)
    if cfg.get("pretrained") is True:
        raise ValueError(
            f"{obj_type}: pretrained=True means 'download from torch hub' in the "
            "reference; pass a local checkpoint path instead")
    if source == "mmcls":
        # the mmcls builder shares the registry protocol: resolve against
        # the port's own registry (mmcls.ResNeXt, mmcls.ResNet)
        from adapt_image_models_torch.models.builder import BACKBONES
        if name not in BACKBONES:
            raise KeyError(f"mmcls.{name}: no registered equivalent; available "
                           f"backbones: {sorted(BACKBONES.module_dict)}")
        cfg["type"] = name
        return cfg
    table = _TORCHVISION if source == "torchvision" else _TIMM
    if name not in table:
        raise KeyError(f"{obj_type}: no native equivalent; supported {source} names: "
                       f"{sorted(table)}")
    new_type, arch_kwargs = table[name]
    cfg.pop("type")
    return {**arch_kwargs, **cfg, "type": new_type}  # the config's keys win
