#!/usr/bin/env python
"""Dataset video integrity check with the port's readers (mirrors
``tools/analysis/check_videos.py``).

Opens every video of a config's split and decodes its first, last and three
random frames (the reference's ``RandomSampleFrames`` probe) through
``open_video(..., strict=True)``, so a truncated tail fails the probe
instead of being papered over by the training path's last-good-frame
substitution. Paths that fail to open or decode are appended to
``--output-file`` and can be deleted with ``--remove-corrupted-videos``.
The command exits 1 when any video is bad.

    python tools/analysis/check_videos_torch.py <config> [--split train]
        [--backend auto|cpp|opencv] [--num-processes N]
        [--output-file invalid-video.txt] [--remove-corrupted-videos]
"""

import argparse
import os
import sys
import multiprocessing
from multiprocessing import cpu_count

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

_WORKER_CFG = {}


def probe_indices(num_frames: int, rng: np.random.Generator) -> np.ndarray:
    """First + last + three random interior frames."""
    assert num_frames > 0
    inds = np.array([0, num_frames - 1], dtype=np.int64)
    if num_frames > 2:
        inds = np.concatenate([inds, rng.integers(1, num_frames - 1, 3)])
    return inds


class _silence_fds:
    """Redirect C-level stdout and stderr to /dev/null for the probe: corrupt
    inputs make the decoder libraries (FFmpeg, OpenCV) print raw bytes that
    would corrupt this tool's own output, which names only file paths."""

    def __enter__(self):
        sys.stdout.flush()
        sys.stderr.flush()
        self._saved = [os.dup(1), os.dup(2)]
        self._null = os.open(os.devnull, os.O_WRONLY)
        os.dup2(self._null, 1)
        os.dup2(self._null, 2)

    def __exit__(self, *exc):
        os.dup2(self._saved[0], 1)
        os.dup2(self._saved[1], 2)
        for fd in (*self._saved, self._null):
            os.close(fd)
        return False


def check_one(item):
    """(idx, filename) -> filename if it is corrupt or missing, else None."""
    idx, filename = item
    from adapt_image_models_torch.data.video_reader import open_video
    try:
        with _silence_fds(), open_video(filename, backend=_WORKER_CFG["backend"],
                                        strict=True) as reader:
            if reader.num_frames <= 0:
                raise ValueError(f"no frames in {filename}")
            rng = np.random.default_rng(idx)
            frames = reader.get_frames(probe_indices(reader.num_frames, rng))
            if frames.shape[0] == 0:
                raise ValueError(f"empty decode for {filename}")
        return None
    except Exception:  # noqa: BLE001 -- any failure marks the file invalid
        return filename


def _init_worker(backend):
    _WORKER_CFG["backend"] = backend


def main(argv=None):
    """Probe the split's videos; returns the invalid paths (empty when
    every video decodes)."""
    p = argparse.ArgumentParser(description="check dataset videos")
    p.add_argument("config")
    p.add_argument("--split", default="train", choices=["train", "val", "test"])
    p.add_argument("--backend", default="auto", choices=["auto", "cpp", "opencv"],
                   help="decode backend ('cpp' is the native csrc/aimdecode path)")
    p.add_argument("--output-file", default="invalid-video.txt")
    p.add_argument("--num-processes", type=int, default=(cpu_count() - 1 or 1))
    p.add_argument("--remove-corrupted-videos", action="store_true")
    p.add_argument("--cfg-options", nargs="+", default=[])
    args = p.parse_args(argv)

    from adapt_image_models_torch.apis import load_config
    from adapt_image_models_torch.data.datasets import build_dataset

    cfg = load_config(args.config, args.cfg_options)
    ds_cfg = dict(cfg["data"][args.split])
    if ds_cfg.get("type") != "VideoDataset":
        raise ValueError("check_videos supports VideoDataset configs only "
                         f"(got {ds_cfg.get('type')})")
    ds_cfg["test_mode"] = args.split != "train"
    dataset = build_dataset(ds_cfg)
    items = [(i, info["filename"]) for i, info in enumerate(dataset.video_infos)]

    if os.path.exists(args.output_file):
        os.remove(args.output_file)

    invalid = []
    if args.num_processes <= 1:
        _init_worker(args.backend)
        results = map(check_one, items)
    else:
        pool = multiprocessing.get_context("spawn").Pool(
            args.num_processes, initializer=_init_worker, initargs=(args.backend,))
        results = pool.imap_unordered(check_one, items)
    for r in results:
        if r is not None:
            invalid.append(r)
            with open(args.output_file, "a") as f:
                f.write(r + "\n")
    if args.num_processes > 1:
        pool.close()
        pool.join()

    if invalid:
        print(f"Checked {len(items)} videos, {len(invalid)} are corrupted/missing.")
        if args.remove_corrupted_videos:
            cnt = 0
            for path in invalid:
                if os.path.exists(path):
                    os.remove(path)
                    cnt += 1
            print(f"Deleted {cnt} corrupted videos.")
        return invalid
    print(f"Checked {len(items)} videos, none are corrupted/missing")
    return invalid


if __name__ == "__main__":
    sys.exit(1 if main() else 0)
