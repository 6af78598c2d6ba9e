"""A benchmark cell cut to a size the CPU runs in seconds: the same files,
entry points and reference, at 2 blocks of width 256 (four 64-wide heads),
2 frames of two by two patches, 10 classes and 2 clips or videos a call."""

import copy
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from aimbench import spec  # noqa: E402

TINY = dict(layers=2, width=256, heads=4, num_frames=2, num_classes=10)


def tiny(workload: str, clips: int = 2, limits=None) -> dict:
    """``spec.resolve(workload)`` at the tiny size, the repo config cut by
    options to the same numbers the reference reads."""
    cell = spec.resolve(workload)
    conf = copy.deepcopy(cell["config"])
    conf["model"].update(TINY, input_resolution=2 * int(conf["model"]["patch_size"]))
    backbone = ("layers", "width", "heads", "num_frames", "input_resolution")
    conf["options"] = list(conf["options"]) + [
        f"model.backbone.{k}={conf['model'][k]}" for k in backbone] + [
        f"model.cls_head.in_channels={TINY['width']}",
        f"model.cls_head.num_classes={TINY['num_classes']}"]
    conf["reference"] = dict(conf["reference"], train_chunk=1, eval_chunk=2)
    mix = dict(cell["traffic"])
    for k in ("clips_per_step", "videos_per_call"):
        if k in mix:
            mix[k] = clips
    return {**cell, "config": conf, "traffic": mix,
            "limits": cell["limits"] if limits is None else limits}
