"""GradCAM for video recognizers (parity: ``adapt_image_models_tpu/utils/
gradcam.py:21-73``; the reference's ``mmaction/utils/gradcam_utils.py``).

As in the JAX package, the CAM source is the backbone's per-frame class
token features (B, T, D), the ViT analog of a last conv feature map. One
backward of the target class's score gives both gradients the JAX package
takes with two ``jax.grad`` calls: with respect to the features (the
per-frame relevance ``relu(sum_c g_c f_c)``) and with respect to the input
frames (the spatial saliency ``sum_C |d score / d x|``, normalised per
frame). The CAM is their product, in [0, 1].

With ``attention_core="fused"`` on CUDA the forward runs the eval kernels
and the backward the vector-Jacobian products of the JAX package's XLA
references (``ops.fused_spatial_step`` and its siblings wrap themselves in
``RecomputedVjp`` when autograd records them), as JAX's ``custom_vjp``
steps take it.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def gradcam(model: torch.nn.Module, imgs: torch.Tensor, target_class: Optional[int] = None,
            device="cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """imgs (B, C, T, H, W) -> (cam (B, T, H, W), scores (B, num_classes)).

    ``model`` is a ``Recognizer3D`` on ``device``; ``imgs`` is moved there.
    ``target_class`` None takes each sample's top-1 class. The scores are
    the softmax of the logits. The model is put in eval mode."""
    device = torch.device(device)
    param = next(model.parameters())
    if param.device.type != device.type or (
            device.index is not None and param.device != device):
        raise ValueError(f"gradcam: the model is on {param.device}, not on {device}")
    model.eval()
    # only the input and the features are differentiated: the weights are
    # held out of the graph for the call, so that no op's backward forms
    # their cotangents (the JAX package's jit drops them)
    params = [p for p in model.parameters() if p.requires_grad]
    try:
        for p in params:
            p.requires_grad_(False)
        with torch.enable_grad():
            x = imgs.to(device).detach().requires_grad_(True)
            feat = model.extract_feat(x)  # (B, T, D)
            logits = model.cls_head(feat)
            if target_class is None:
                target = logits.argmax(-1)
            else:
                target = torch.full((x.shape[0],), target_class, device=device)
            score = logits.gather(1, target[:, None]).sum()
            g_feat, g_x = torch.autograd.grad(score, (feat, x))
    finally:
        for p in params:
            p.requires_grad_(True)
    cam_t = torch.relu((g_feat.float() * feat.detach().float()).sum(-1))  # (B, T)
    sal = g_x.float().abs().sum(1)  # (B, T, H, W)
    sal = sal / (sal.amax(dim=(2, 3), keepdim=True) + 1e-8)
    cam = sal * (cam_t / (cam_t.amax(dim=1, keepdim=True) + 1e-8))[..., None, None]
    return cam, torch.softmax(logits.detach().float(), dim=-1)
