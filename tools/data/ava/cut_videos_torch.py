#!/usr/bin/env python
"""Cut each AVA video to its 15th-30th minute with the port's trim helper
(mirrors ``tools/data/ava/cut_videos.py``: ``ffmpeg -ss 900 -t 901`` of the
reference, re-encoded through ``tools/data/_trim_torch.py``).

    python tools/data/ava/cut_videos_torch.py SRC_DIR OUT_DIR \
        [--start 900] [--duration 901] [--fps 30]
"""

import argparse
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))
from _trim_torch import trim_video  # noqa: E402


def main(argv=None):
    """Trim every file of ``src_dir`` not yet in ``out_dir``; returns
    {name: ok} of the files it trimmed."""
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("src_dir")
    parser.add_argument("out_dir")
    parser.add_argument("--start", type=float, default=900.0)
    parser.add_argument("--duration", type=float, default=901.0)
    parser.add_argument("--fps", type=float, default=30.0)
    args = parser.parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    done = {}
    for name in sorted(os.listdir(args.src_dir)):
        src = osp.join(args.src_dir, name)
        dst = osp.join(args.out_dir, osp.splitext(name)[0] + ".mp4")
        if osp.exists(dst):
            continue
        done[name] = trim_video(src, dst, args.start, args.duration, fps=args.fps)
        print(("ok   " if done[name] else "FAIL ") + name, flush=True)
    return done


if __name__ == "__main__":
    main()
