"""Async host data loader (parity: ``adapt_image_models_tpu/data/loader.py``).

Replaces torch ``DataLoader`` + ``DistributedSampler`` + ``collate``
(reference ``mmaction/datasets/builder.py:46-132``,
``datasets/samplers/distributed_sampler.py:8-44``) with:

* seeded per-epoch shuffling with per-process (host) sharding — same
  determinism contract as the reference's epoch-seeded DistributedSampler
* a thread pool decoding/transforming samples into fixed-shape uint8 arrays
  (an audio recipe's processor: float32 spectrogram segments; a dataset
  with its own ``prepare_sample``, ``AudioVisualDataset``, ``PoseDataset``,
  ``RawVideoDataset``, ``ActivityNetDataset``: whatever that returns; a
  string or list value is kept as a list of the samples' values)
* prefetch: up to ``prefetch`` host batches are assembled while the
  previous step computes; the device stage (``transforms.make_prepare_fn``)
  moves each batch to the model's device

Per-sample rng is derived from (seed, epoch, index) so any sample is
reproducible in isolation regardless of worker scheduling.

``RoundRobinLoader`` alternates OmniSource's sources, a ``VideoLoader``
each (JAX ``loader.py:29-68``).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterator, Optional

import numpy as np

from adapt_image_models_torch.data.audio import AudioSampleProcessor
from adapt_image_models_torch.data.pipeline import SampleProcessor, build_sample_processor


class RoundRobinLoader:
    """OmniSource's alternation over several loaders (reference
    ``mmaction/core/runner/omnisource_runner.py``): each cycle takes
    ``ratios[0]`` batches of the main loader, then ``ratios[i]`` of each
    auxiliary loader i in turn (the recipes' ``data.train_ratio``, e.g.
    ``[2, 1, 1, 1]``); the main loader's batches drive the epoch. Each
    batch carries its loader's index as ``batch['source']``.

    An auxiliary loader that runs out starts its next epoch
    (``set_epoch(epoch + 1)``) and is iterated again, so its samples are
    drawn and augmented afresh and no yielded batch is kept. ``set_epoch``
    never moves an auxiliary loader back onto an epoch it has served: it
    goes on from ``max(epoch, its last epoch + 1)``, so no (epoch, index)
    sample of it repeats across outer epochs. Over its first pass the
    sequence of sources and samples is the JAX loader's, whose
    ``itertools.cycle`` (``loader.py:59``) keeps every batch of that pass
    and replays them, augmentations included, from then on (ROADMAP queue
    3)."""

    def __init__(self, loaders, ratios=None):
        if not loaders:
            raise ValueError("need at least one loader")
        self.loaders = list(loaders)
        self.ratios = [int(r) for r in ratios] if ratios else [1] * len(loaders)
        if len(self.ratios) != len(self.loaders) or min(self.ratios) < 1:
            raise ValueError(f"train_ratio {ratios} does not match "
                             f"{len(self.loaders)} sources")
        # the last epoch each auxiliary loader was iterated at
        self._served = [None] * len(self.loaders)

    def set_epoch(self, epoch: int):
        self.loaders[0].set_epoch(epoch)
        for loader, served in zip(self.loaders[1:], self._served[1:]):
            loader.set_epoch(epoch if served is None else max(epoch, served + 1))

    def _iter_aux(self, i):
        self._served[i] = self.loaders[i].epoch
        return iter(self.loaders[i])

    def __len__(self):
        # the main loader's batches drive the epoch: each group of
        # ratios[0] of them is followed by sum(ratios[1:]) auxiliary ones
        n_main = len(self.loaders[0])
        return n_main + n_main // self.ratios[0] * sum(self.ratios[1:])

    def _next_aux(self, iters, i):
        try:
            return next(iters[i])
        except StopIteration:
            self.loaders[i].set_epoch(self.loaders[i].epoch + 1)
            iters[i] = self._iter_aux(i)
        try:
            return next(iters[i])
        except StopIteration:
            raise ValueError(f"OmniSource source {i} yields no batch") from None

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        iters = [iter(self.loaders[0])] + [self._iter_aux(i)
                                           for i in range(1, len(self.loaders))]
        while True:
            for _ in range(self.ratios[0]):
                try:
                    yield {**next(iters[0]), "source": 0}
                except StopIteration:
                    return
            for i in range(1, len(self.loaders)):
                for _ in range(self.ratios[i]):
                    yield {**self._next_aux(iters, i), "source": i}


def collate(samples) -> Dict[str, Any]:
    """Samples -> one batch: each value stacked, a string or list value
    (ActivityNet's gt_bbox) kept as the list of the samples' values."""
    batch = {}
    for k, v0 in samples[0].items():
        if isinstance(v0, (str, list)):
            batch[k] = [s[k] for s in samples]
        else:
            batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    return batch


def process_info(processor, info: Dict[str, Any], label, rng: np.random.Generator):
    """(clips, label) of the annotation ``info`` through ``processor``: a
    video or audio file (``filename``), or a rawframe directory
    (``frame_dir``, RGB or Flow frames)."""
    if "filename" in info:  # a video or an audio file
        return processor(info["filename"], label, rng=rng,
                         total_frames=info.get("total_frames"),
                         start_index=info.get("start_index", 0))
    from adapt_image_models_torch.data.video_reader import FlowFrameReader, RawFrameReader
    flow = info.get("modality") == "Flow"
    reader = (FlowFrameReader if flow else RawFrameReader)(
        info["frame_dir"], info["total_frames"],
        filename_tmpl=info.get("filename_tmpl", "{}_{:05d}.jpg" if flow else "img_{:05}.jpg"),
        start_index=info.get("start_index", 1), offset=info.get("offset", 0))
    return processor(reader, label, rng=rng, total_frames=info["total_frames"],
                     start_index=info.get("start_index", 1))


class VideoLoader:
    def __init__(self, dataset, pipeline, batch_size: int,
                 *, shuffle: bool = False, seed: int = 0,
                 num_workers: int = 8, prefetch: int = 2,
                 drop_last: Optional[bool] = None,
                 num_shards: int = 1, shard_index: int = 0):
        self.dataset = dataset
        if hasattr(dataset, "prepare_sample"):
            # the dataset prepares its own samples (AudioVisualDataset's
            # two modalities from one rng state, PoseDataset's heatmaps,
            # RawVideoDataset's clip choice)
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
        clips, label = process_info(self.processor, info, info["label"], rng)
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
                        # no local of this thread keeps the batch once
                        # it is queued (nor the consumer once yielded)
                        out_q.put(collate(list(pool.map(self._load_one, batch_idx))))
                out_q.put(None)
            except BaseException as e:  # forward errors to the consumer
                out_q.put(e)

        thread = threading.Thread(target=produce, daemon=True)
        thread.start()
        try:
            while True:
                # a list that the yield empties: the suspended generator
                # holds no yielded batch
                item = [out_q.get()]
                if item[0] is None:
                    return
                if isinstance(item[0], BaseException):
                    raise item[0]
                yield item.pop()
        finally:
            stop.set()
            # drain so the producer can exit
            while not out_q.empty():
                try:
                    out_q.get_nowait()
                except queue.Empty:
                    break
