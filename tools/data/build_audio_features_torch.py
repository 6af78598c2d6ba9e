#!/usr/bin/env python
"""Turn extracted WAVs into log-mel spectrogram feature files with the
port's mel implementation (mirrors ``tools/data/build_audio_features.py``:
``data/audio.py``'s ``load_wav`` and ``melspectrogram``, the functions the
on-line ``AudioFeatureDataset`` path runs, so offline features match it).

    python tools/data/build_audio_features_torch.py AUDIO_ROOT DST_ROOT \
        [--level 2] [--ext wav] [--sample-rate 16000] [--num-mels 80] \
        [--fft-size 1280] [--hop-size 320] [--part 0/1] [--num-worker 8]

``--part k/n`` processes the k-th of n shards. Workers are spawned
processes; ``--num-worker 1`` builds in this process.
"""

import argparse
import glob
import os
import os.path as osp
import sys
import multiprocessing

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))


def build_one(task):
    """(src, dst, args) -> (src, ok): ``dst`` holds the (T, n_mels) float32
    log-mel spectrogram; an existing ``dst`` counts as done."""
    src, dst, args = task
    from adapt_image_models_torch.data.audio import load_wav, melspectrogram
    os.makedirs(osp.dirname(dst), exist_ok=True)
    if osp.exists(dst):
        return src, True
    try:
        y, sr = load_wav(src)
        if args.sample_rate and sr != args.sample_rate:
            # linear resampling, as the loader's own fallback
            n_out = int(round(len(y) * args.sample_rate / sr))
            y = np.interp(np.linspace(0, len(y) - 1, n_out),
                          np.arange(len(y)), y).astype(np.float32)
            sr = args.sample_rate
        spec = melspectrogram(y, sr=sr, n_fft=args.fft_size, hop_length=args.hop_size,
                              n_mels=args.num_mels)
        np.save(dst, spec.astype(np.float32))
        return src, True
    except Exception as e:  # noqa: BLE001 -- one bad file does not stop the rest
        print(f"FAILED {src}: {e}", file=sys.stderr)
        return src, False


def main(argv=None):
    """Build the features of this shard's files; returns [(wav, ok)]."""
    p = argparse.ArgumentParser()
    p.add_argument("audio_home_path")
    p.add_argument("spectrogram_save_path")
    p.add_argument("--level", type=int, default=2, choices=[1, 2])
    p.add_argument("--ext", default="wav")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--num-mels", type=int, default=80)
    p.add_argument("--fft-size", type=int, default=1280)
    p.add_argument("--hop-size", type=int, default=320)
    p.add_argument("--num-worker", type=int, default=8)
    p.add_argument("--part", default="0/1", help="k/n: process the k-th of n shards")
    args = p.parse_args(argv)

    pattern = osp.join(args.audio_home_path, *("*",) * args.level) + "." + args.ext
    k, n = (int(x) for x in args.part.split("/"))
    wavs = sorted(glob.glob(pattern))[k::n]
    print(f"{len(wavs)} wav files (shard {k}/{n})")
    tasks = [(wv, osp.join(args.spectrogram_save_path,
                           osp.splitext(osp.relpath(wv, args.audio_home_path))[0] + ".npy"),
              args) for wv in wavs]
    if args.num_worker <= 1:
        results = [build_one(t) for t in tasks]
    else:
        with multiprocessing.get_context("spawn").Pool(args.num_worker) as pool:
            results = pool.map(build_one, tasks)
    ok = sum(1 for _, good in results if good)
    print(f"done: {ok}/{len(wavs)} ok")
    return results


if __name__ == "__main__":
    main()
