"""Checkpoints with the reference's ergonomics (parity:
``adapt_image_models_tpu/core/checkpoint.py:34-151``), on ``torch.save``.

``<work_dir>/ckpt_<epoch>.pth`` holds ``{'state_dict': the whole model,
'optimizer': ..., 'step': ..., 'epoch': ...}``, so it loads through
``init_recognizer(cfg, checkpoint=...)`` like a released AIM checkpoint.
``checkpoints.json`` keeps the ``latest`` pointer for ``auto_resume``, the
list ``max_keep`` prunes, and the EvalHook-style ``best`` record.

Under a process group every rank calls ``save`` and ``save_best`` with the
same state; rank 0 alone writes, then every rank waits at a barrier, so a
rank that goes on to ``latest_epoch`` or ``restore`` reads the files rank 0
wrote. Every rank restores from the same file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

import torch

from adapt_image_models_torch.parallel.distributed import barrier, is_main_process


class CheckpointManager:
    def __init__(self, work_dir: str, max_keep: Optional[int] = None):
        self.work_dir = os.path.abspath(work_dir)
        os.makedirs(self.work_dir, exist_ok=True)
        self.max_keep = max_keep

    def path(self, tag) -> str:
        return os.path.join(self.work_dir, f"ckpt_{tag}.pth")

    def _meta_path(self) -> str:
        return os.path.join(self.work_dir, "checkpoints.json")

    def _read_meta(self) -> Dict[str, Any]:
        if os.path.exists(self._meta_path()):
            with open(self._meta_path()) as f:
                return json.load(f)
        return {"latest": None, "all": [], "best": None, "best_score": None}

    def _write_meta(self, meta: Dict[str, Any]) -> None:
        tmp = self._meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1)
        os.replace(tmp, self._meta_path())

    @staticmethod
    def _write(state, epoch: int, path: str) -> None:
        tmp = path + ".tmp"
        torch.save({"state_dict": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": state.step, "epoch": epoch}, tmp)
        os.replace(tmp, path)

    def save(self, state, epoch: int) -> str:
        path = self.path(epoch)
        if is_main_process():
            self._write(state, epoch, path)
            meta = self._read_meta()
            meta["latest"] = epoch
            meta["all"] = sorted(set(meta["all"] + [epoch]))
            if self.max_keep:
                keep = meta["all"][-self.max_keep:]
                for e in meta["all"]:
                    if e not in keep and e != meta.get("best") and os.path.exists(self.path(e)):
                        os.remove(self.path(e))
                meta["all"] = keep
            self._write_meta(meta)
        barrier()
        return path

    def save_best(self, state, epoch: int, score: float) -> bool:
        """EvalHook ``save_best`` (rule 'greater'): keep ``ckpt_best.pth``
        when ``score`` beats the best so far."""
        meta = self._read_meta()
        prev = meta.get("best_score")
        better = prev is None or score > prev
        barrier()  # every rank has read the record before rank 0 rewrites it
        if better and is_main_process():
            self._write(state, epoch, self.path("best"))
            meta["best"], meta["best_score"] = epoch, float(score)
            self._write_meta(meta)
        barrier()
        return better

    def latest_epoch(self) -> Optional[int]:
        return self._read_meta().get("latest")

    def _load(self, epoch) -> Dict[str, Any]:
        if epoch is None:
            epoch = self.latest_epoch()
            if epoch is None:
                raise FileNotFoundError(f"no checkpoints in {self.work_dir}")
        return torch.load(self.path(epoch), map_location="cpu", weights_only=True)

    def restore(self, state, epoch=None):
        """Load the model, optimizer and step of ``epoch`` (the latest when
        None; ``'best'`` also works) into ``state``; returns (state, epoch)."""
        ckpt = self._load(epoch)
        state.model.load_state_dict(ckpt["state_dict"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        return state, int(ckpt["epoch"])
