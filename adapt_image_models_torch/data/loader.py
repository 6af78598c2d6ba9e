"""Async host data loader (parity: ``adapt_image_models_tpu/data/loader.py``).

Replaces torch ``DataLoader`` + ``DistributedSampler`` + ``collate``
(reference ``mmaction/datasets/builder.py:46-132``,
``datasets/samplers/distributed_sampler.py:8-44``) with:

* seeded per-epoch shuffling with per-process (host) sharding — same
  determinism contract as the reference's epoch-seeded DistributedSampler
* a thread pool decoding/transforming samples into fixed-shape uint8 arrays
  (an audio recipe's processor: float32 spectrogram segments; a dataset
  with its own ``prepare_sample``, ``AudioVisualDataset``: whatever that
  returns)
* prefetch: up to ``prefetch`` host batches are assembled while the
  previous step computes; the device stage (``transforms.make_prepare_fn``)
  moves each batch to the model's device

Per-sample rng is derived from (seed, epoch, index) so any sample is
reproducible in isolation regardless of worker scheduling.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np

from adapt_image_models_torch.data.audio import AudioSampleProcessor
from adapt_image_models_torch.data.pipeline import SampleProcessor, build_sample_processor


class VideoLoader:
    def __init__(self, dataset, pipeline, batch_size: int,
                 *, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 2,
                 drop_last: Optional[bool] = None,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        if hasattr(dataset, "prepare_sample"):
            # the dataset prepares its own samples (AudioVisualDataset's
            # two modalities from one rng state)
            self.processor = None
        elif isinstance(pipeline, (SampleProcessor, AudioSampleProcessor)):
            self.processor = pipeline
        else:
            self.processor = build_sample_processor(pipeline)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.prefetch = prefetch
        self.drop_last = shuffle if drop_last is None else drop_last
        self.num_shards = num_shards
        self.shard_index = shard_index
        self.epoch = 0

    def set_epoch(self, epoch: int):
        self.epoch = epoch

    def _epoch_indices(self) -> np.ndarray:
        n = len(self.dataset)
        if self.shuffle and getattr(self.dataset, "sample_by_class", False):
            # class-balanced draw (reference base.py:89-100): per-epoch
            # resample with per-sample weights w_class^power
            rng = np.random.default_rng((self.seed, self.epoch))
            p = self.dataset.class_weights(
                power=getattr(self.dataset, "power", 0.0)).astype(np.float64)
            order = rng.choice(n, size=n, replace=True, p=p / p.sum())
        elif self.shuffle:
            rng = np.random.default_rng((self.seed, self.epoch))
            order = rng.permutation(n)
        else:
            order = np.arange(n)
        # pad so every shard sees the same number of samples (reference
        # DistributedSampler pads by wrapping)
        per_shard = -(-n // self.num_shards)
        padded = np.concatenate([order, order[:per_shard * self.num_shards - n]])
        return padded[self.shard_index::self.num_shards]

    def _load_one(self, idx: int) -> Dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, int(idx)))
        if self.processor is None:
            return self.dataset.prepare_sample(int(idx), rng)
        info = self.dataset[int(idx)]
        if "filename" in info:  # a video or an audio file
            clips, label = self.processor(
                info["filename"], info["label"], rng=rng,
                total_frames=info.get("total_frames"),
                start_index=info.get("start_index", 0))
        else:  # rawframes
            from adapt_image_models_torch.data.video_reader import (
                FlowFrameReader, RawFrameReader,
            )
            reader_cls = (FlowFrameReader
                          if info.get("modality") == "Flow"
                          else RawFrameReader)
            reader = reader_cls(
                info["frame_dir"], info["total_frames"],
                filename_tmpl=info.get(
                    "filename_tmpl",
                    "{}_{:05d}.jpg" if info.get("modality") == "Flow"
                    else "img_{:05}.jpg"),
                start_index=info.get("start_index", 1),
                offset=info.get("offset", 0))
            clips, label = self.processor(
                reader, info["label"], rng=rng,
                total_frames=info["total_frames"],
                start_index=info.get("start_index", 1))
        return {"imgs": clips, "label": label}

    def __len__(self) -> int:
        n = len(self._epoch_indices())
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        indices = self._epoch_indices()
        nb = len(self)
        batches = [indices[i * self.batch_size:(i + 1) * self.batch_size]
                   for i in range(nb)]

        out_q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def produce():
            try:
                with ThreadPoolExecutor(self.num_workers) as pool:
                    for batch_idx in batches:
                        if stop.is_set():
                            return
                        samples = list(pool.map(self._load_one, batch_idx))
                        batch = {}
                        for k, v0 in samples[0].items():
                            if isinstance(v0, str):
                                batch[k] = [s[k] for s in samples]
                            else:
                                batch[k] = np.stack(
                                    [np.asarray(s[k]) for s in samples])
                        out_q.put(batch)
                out_q.put(None)
            except BaseException as e:  # forward errors to the consumer
                out_q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                item = out_q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can exit
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
