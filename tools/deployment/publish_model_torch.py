#!/usr/bin/env python
"""Checkpoint publishing of the port (mirrors
``tools/deployment/publish_model.py``): strip the training state, keep the
weights, stamp a content hash.

    python tools/deployment/publish_model_torch.py <ckpt.pth> <out_dir>

``<ckpt.pth>`` is a checkpoint of the port's trainer
(``core/checkpoint.py``: ``{'state_dict', 'optimizer', 'step', 'epoch'}``).
``<out_dir>`` is made anew and holds ``<name>-<hash>.pth``, with only
``state_dict`` and ``epoch`` (it loads through
``init_recognizer(cfg, checkpoint=...)``), and ``PUBLISH.json`` with
``sha256_prefix``, ``source`` and ``file``. The hash is the first 8 hex
digits of a SHA-256 over the published tensors' bytes (each tensor on the
CPU, contiguous, its raw little-endian bytes) in the sorted order of their
``state_dict`` keys: it moves with any weight and not with the optimizer
state, the step or the file's serialisation.

An existing ``<out_dir>`` is replaced only when it is empty or an earlier
publication (it holds ``PUBLISH.json``); one that holds the source
checkpoint, or other files, is refused, so a work dir is never removed.
"""

import argparse
import hashlib
import json
import os
import shutil


def weights_digest(state_dict) -> str:
    """The 8-hex-digit SHA-256 prefix of ``state_dict``'s tensors' bytes in
    sorted key order."""
    import torch
    h = hashlib.sha256()
    for key in sorted(state_dict):
        flat = state_dict[key].detach().cpu().contiguous().reshape(-1)
        h.update(flat.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:8]


def main(argv=None):
    """Publish ``ckpt`` into ``out``; returns the published file's path."""
    p = argparse.ArgumentParser()
    p.add_argument("ckpt", help="checkpoint .pth of the port's trainer")
    p.add_argument("out", help="output dir for the published checkpoint")
    args = p.parse_args(argv)

    out, source = os.path.abspath(args.out), os.path.abspath(args.ckpt)
    real_out = os.path.realpath(out)
    if os.path.commonpath([real_out, os.path.realpath(source)]) == real_out:
        p.error(f"{args.out} holds the source checkpoint {args.ckpt}: publish elsewhere")
    if os.path.exists(out) and os.listdir(out) \
            and not os.path.exists(os.path.join(out, "PUBLISH.json")):
        p.error(f"{args.out} exists and is not an earlier publication (no PUBLISH.json)")

    import torch
    ckpt = torch.load(source, map_location="cpu", weights_only=True)
    published = {"state_dict": ckpt.get("state_dict", ckpt), "epoch": ckpt.get("epoch")}
    digest = weights_digest(published["state_dict"])
    if os.path.exists(out):
        shutil.rmtree(out)
    os.makedirs(out)
    name = os.path.splitext(os.path.basename(args.ckpt))[0]
    path = os.path.join(out, f"{name}-{digest}.pth")
    torch.save(published, path)
    with open(os.path.join(out, "PUBLISH.json"), "w") as f:
        json.dump({"sha256_prefix": digest, "source": source,
                   "file": os.path.basename(path)}, f, indent=1)
    print(f"published to {out} (hash {digest})")
    return path


if __name__ == "__main__":
    main()
