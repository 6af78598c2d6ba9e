#!/usr/bin/env python
"""Extract audio tracks from videos to WAV with the port's binding of the
in-repo C++ library (mirrors ``tools/data/extract_audio.py``:
``data/cpp_decoder.py::extract_audio`` decodes and resamples natively, no
ffmpeg CLI).

    python tools/data/extract_audio_torch.py ROOT DST_ROOT \
        [--level 2] [--ext mp4] [--sample-rate 16000] [--stereo] \
        [--num-worker 8]

A failed video is named on stderr and appended to
``extract_wav_err_file.txt`` in the working directory, as the reference
does. Workers are spawned processes; ``--num-worker 1`` extracts in
this process.
"""

import argparse
import glob
import os
import os.path as osp
import sys
import multiprocessing

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))


def extract_one(task):
    """(src, dst, args) -> (src, ok); an existing ``dst`` counts as done."""
    src, dst, args = task
    from adapt_image_models_torch.data.cpp_decoder import extract_audio
    os.makedirs(osp.dirname(dst), exist_ok=True)
    if osp.exists(dst):
        return src, True
    try:
        extract_audio(src, dst, sample_rate=args.sample_rate, mono=not args.stereo)
        return src, True
    except Exception as e:  # noqa: BLE001 -- one bad video does not stop the rest
        print(f"FAILED {src}: {e}", file=sys.stderr)
        with open("extract_wav_err_file.txt", "a+") as f:
            f.write(src + "\n")
        return src, False


def main(argv=None):
    """Extract every video of the tree; returns [(video, ok)]."""
    p = argparse.ArgumentParser()
    p.add_argument("root", help="source video directory")
    p.add_argument("dst_root", help="output audio directory")
    p.add_argument("--level", type=int, default=2, choices=[1, 2])
    p.add_argument("--ext", default="mp4")
    p.add_argument("--sample-rate", type=int, default=16000,
                   help="0 keeps the source rate")
    p.add_argument("--stereo", action="store_true")
    p.add_argument("--num-worker", type=int, default=8)
    args = p.parse_args(argv)

    pattern = osp.join(args.root, *("*",) * args.level) + "." + args.ext
    videos = sorted(glob.glob(pattern))
    print(f"{len(videos)} videos under {args.root}")
    tasks = [(v, osp.join(args.dst_root, osp.splitext(osp.relpath(v, args.root))[0] + ".wav"),
              args) for v in videos]
    if args.num_worker <= 1:
        results = [extract_one(t) for t in tasks]
    else:
        with multiprocessing.get_context("spawn").Pool(args.num_worker) as pool:
            results = pool.map(extract_one, tasks)
    ok = sum(1 for _, good in results if good)
    print(f"done: {ok}/{len(videos)} ok")
    return results


if __name__ == "__main__":
    main()
