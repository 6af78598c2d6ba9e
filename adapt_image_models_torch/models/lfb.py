"""Long-term feature bank (parity: ``adapt_image_models_tpu/models/lfb.py``,
a copy in numpy; reference ``models/common/lfb.py:17``).

The bank lives on the host, and ``sample_long_term_features`` returns a
fixed (window_size * max_num_sampled_feat, C) float32 window, zero-padded,
which the detector takes as an input (``lt_feat``) instead of the
reference's in-graph dict lookup. Draws come from an explicit
``np.random.Generator`` (the bank's own, seeded from ``seed``, unless one
is given), in the JAX package's order.

Storage, as the JAX package's: one ``lfb_<mode>.npz`` a dataset mode with
keys ``"<video_id>,<sec>"`` -> (num_rois, C) float16 arrays (``'ram'``
backend), or for banks too big for memory a flat ``<prefix>.rows.npy``
with an ``<prefix>.index.npz`` of (offset, count) a key, memory-mapped so
that a read touches only the sampled rows (``'mmap'``, the reference's
lmdb device). ``'auto'`` takes the mmap files where they exist.
"""

from __future__ import annotations

import os.path as osp
from typing import Dict, Optional, Sequence

import numpy as np


def save_lfb(path: str, bank: Dict[str, Dict[int, np.ndarray]],
             half_precision: bool = True) -> None:
    """bank {video_id: {sec: (n, C)}} -> one npz file."""
    flat = {}
    for video_id, secs in bank.items():
        for sec, feats in secs.items():
            flat[f"{video_id},{int(sec)}"] = np.asarray(
                feats, np.float16 if half_precision else np.float32)
    np.savez_compressed(path, **flat)


def save_lfb_mmap(path_prefix: str, bank: Dict[str, Dict[int, np.ndarray]],
                  half_precision: bool = True) -> None:
    """bank -> ``<prefix>.rows.npy`` (N_total, C) and ``<prefix>.index.npz``
    (keys, offsets, counts)."""
    keys, offsets, counts, rows = [], [], [], []
    off = 0
    for video_id, secs in bank.items():
        for sec, feats in secs.items():
            feats = np.asarray(feats)
            keys.append(f"{video_id},{int(sec)}")
            offsets.append(off)
            counts.append(len(feats))
            rows.append(feats)
            off += len(feats)
    flat = np.concatenate(rows, axis=0).astype(np.float16 if half_precision else np.float32)
    np.save(path_prefix + ".rows.npy", flat)
    np.savez(path_prefix + ".index.npz", keys=np.asarray(keys),
             offsets=np.asarray(offsets, np.int64), counts=np.asarray(counts, np.int64))


class _MmapMode:
    """One dataset mode: a memory-mapped row file and its key index."""

    def __init__(self, path_prefix: str):
        self.rows = np.load(path_prefix + ".rows.npy", mmap_mode="r")
        with np.load(path_prefix + ".index.npz") as z:
            self.index = {str(k): (int(o), int(c))
                          for k, o, c in zip(z["keys"], z["offsets"], z["counts"])}

    def get(self, key: str) -> Optional[np.ndarray]:
        oc = self.index.get(key)
        if oc is None:
            return None
        off, cnt = oc
        return self.rows[off:off + cnt]


class LFB:
    """The bank of ``dataset_modes`` under ``lfb_prefix_path``, on the
    ``backend`` ``'ram'``, ``'mmap'`` or ``'auto'``."""

    def __init__(self, lfb_prefix_path: str, max_num_sampled_feat: int = 5,
                 window_size: int = 60, lfb_channels: int = 2048,
                 dataset_modes: Sequence[str] = ("train", "val"), seed: int = 0,
                 backend: str = "auto"):
        if not osp.exists(lfb_prefix_path):
            raise ValueError(f"lfb prefix path {lfb_prefix_path} does not exist!")
        self.lfb_prefix_path = lfb_prefix_path
        self.max_num_sampled_feat = max_num_sampled_feat
        self.window_size = window_size
        self.lfb_channels = lfb_channels
        if isinstance(dataset_modes, str):
            dataset_modes = (dataset_modes,)
        self.rng = np.random.default_rng(seed)
        self.lfb: Dict[str, Dict[int, np.ndarray]] = {}  # the ram backend's
        self._mmap_modes = []
        for mode in dataset_modes:
            prefix = osp.normpath(osp.join(lfb_prefix_path, f"lfb_{mode}"))
            if backend == "mmap" or (backend == "auto" and osp.exists(prefix + ".rows.npy")):
                self._mmap_modes.append(_MmapMode(prefix))
                continue
            with np.load(prefix + ".npz") as z:
                for key in z.files:
                    video_id, sec = key.rsplit(",", 1)
                    self.lfb.setdefault(video_id, {})[int(sec)] = z[key]

    def sample_long_term_features(self, video_id: str, timestamp: int,
                                  rng: Optional[np.random.Generator] = None) -> np.ndarray:
        """(window_size * max_num_sampled_feat, C) float32: up to
        ``max_num_sampled_feat`` features of each second of the window
        centred on ``timestamp``, drawn without replacement, zero where a
        second has fewer (reference ``lfb.py:152-178``)."""
        rng = rng or self.rng
        video_features = self.lfb.get(video_id, {})
        w, k = self.window_size, self.max_num_sampled_feat
        start = timestamp - (w // 2)
        out = np.zeros((w * k, self.lfb_channels), np.float32)
        for idx, sec in enumerate(range(start, start + w)):
            feats = video_features.get(sec)
            if feats is None:
                for mode in self._mmap_modes:
                    feats = mode.get(f"{video_id},{sec}")
                    if feats is not None:
                        break
            if feats is None or len(feats) == 0:
                continue
            n = min(len(feats), k)
            chosen = rng.choice(len(feats), n, replace=False)
            out[idx * k:idx * k + n] = feats[chosen].astype(np.float32)
        return out

    def __getitem__(self, img_key: str) -> np.ndarray:
        video_id, timestamp = img_key.split(",")
        return self.sample_long_term_features(video_id, int(timestamp))

    def __len__(self) -> int:
        vids = set(self.lfb)
        for mode in self._mmap_modes:
            vids.update(k.rsplit(",", 1)[0] for k in mode.index)
        return len(vids)
