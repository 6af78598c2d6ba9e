"""The benchmark's own FLOP count against the port's counter
(``utils/flops.py::count_flops``, torch's FlopCounterMode): the forward of
both configurations on the meta device, and a tiny train step's forward
and backward on the CPU through the framework-op path, where autograd
forms exactly the products the count says a step requires."""

import pytest
import torch

from tiny_cells import tiny
from aimbench import cells, flops, spec
from aimbench.inputs import draw_weights
from aimbench.reference.aim import param_spec

CONFIGS = {"aim-b16-8f-k400": "aim-b16-8f.train-b32", "aim-l14-32f-k400": "aim-l14-32f.train-b8"}


def _model(conf, device, **backbone):
    from adapt_image_models_torch.apis.inference import model_config
    from adapt_image_models_torch.models import build_model
    cfg = cells.port_config(conf)
    mc = model_config(cfg, "test")
    mc.pop("test_cfg", None)
    mc.pop("train_cfg", None)
    mc["backbone"] = {**mc["backbone"], **backbone}
    return build_model(mc, device=device)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_forward_count_equals_count_flops(name):
    from adapt_image_models_torch.utils.flops import count_flops
    conf = spec.resolve(CONFIGS[name])["config"]
    m = conf["model"]
    model = _model(conf, "meta").eval()
    res = int(m["input_resolution"])
    assert count_flops(model, (1, 3, int(m["num_frames"]), res, res)) == flops.forward_flops(m)


def test_train_count_equals_autograd_products():
    """A train step's products through the framework ops, frozen CLIP
    weights without a gradient, counted by FlopCounterMode."""
    from torch.utils.flop_counter import FlopCounterMode
    from adapt_image_models_torch.parallel import freeze_params
    conf = tiny("aim-b16-8f.train-b32")["config"]
    m = conf["model"]
    model = _model(conf, "cpu", attention_core="xla", compute_dtype="float32")
    model.load_state_dict(draw_weights(param_spec(m), 0, m["width"], "cpu"))
    freeze_params(model)
    model.train()
    x = torch.randn(2, 3, m["num_frames"], m["input_resolution"], m["input_resolution"])
    with FlopCounterMode(display=False) as counter:
        loss = model(x).logsumexp(-1).sum()
        torch.autograd.grad(loss, [p for p in model.parameters() if p.requires_grad])
    assert counter.get_total_flops() == 2 * flops.train_flops(m)
