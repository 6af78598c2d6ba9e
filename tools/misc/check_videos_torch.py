#!/usr/bin/env python
"""Scan an annotation list for unreadable or corrupt videos with the port's
readers (mirrors ``tools/misc/check_videos.py``): each video is opened and
its first and last frames decoded.

    python tools/misc/check_videos_torch.py <ann_file> [--prefix dir] \
        [--workers 8] [--out bad.txt]
"""

import argparse
import os
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def check_one(path):
    """(path, None) when it decodes, else (path, the error)."""
    from adapt_image_models_torch.data.video_reader import open_video
    try:
        r = open_video(path)
        n = r.num_frames
        if n <= 0:
            return path, "zero frames"
        r.get_frames([0, max(0, n - 1)])
        r.close()
        return path, None
    except Exception as e:  # noqa: BLE001 -- report every decode failure
        return path, f"{type(e).__name__}: {e}"


def main(argv=None):
    """Print each bad video and the count; returns [(path, error)]."""
    p = argparse.ArgumentParser()
    p.add_argument("ann_file")
    p.add_argument("--prefix", default="")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--out", default=None, help="write bad paths to this file")
    args = p.parse_args(argv)

    paths = []
    with open(args.ann_file) as f:
        for line in f:
            if line.strip():
                paths.append(os.path.join(args.prefix, line.split()[0]))

    bad = []
    with ThreadPoolExecutor(args.workers) as pool:
        for path, err in pool.map(check_one, paths):
            if err:
                bad.append((path, err))
                print(f"BAD {path}: {err}")
    print(f"checked {len(paths)} videos, {len(bad)} bad")
    if args.out and bad:
        with open(args.out, "w") as f:
            f.write("\n".join(p for p, _ in bad))
    return bad


if __name__ == "__main__":
    main()
