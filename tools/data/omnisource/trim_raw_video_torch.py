#!/usr/bin/env python
"""Decompose an OmniSource raw video into 10-second clips with the port's
trim helper (mirrors ``tools/data/omnisource/trim_raw_video.py``). The raw
video is removed afterwards.

    python tools/data/omnisource/trim_raw_video_torch.py VIDEO
"""

import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)) + "/..")
from _trim_torch import trim_video, video_duration  # noqa: E402


def trim(vid_name: str):
    """``<name>/part_<i>.mp4`` for each 10 s of ``vid_name``, which is then
    removed; a video whose duration cannot be read is left as it is."""
    try:
        lt = video_duration(vid_name)
    except Exception:  # noqa: BLE001 -- the reference's tolerance of a bad file
        print(f"get_duration failed for video {vid_name}", flush=True)
        return
    name, _ = osp.splitext(vid_name)
    os.makedirs(name, exist_ok=True)
    i = 0
    while i * 10 < lt:
        trim_video(vid_name, osp.join(name, f"part_{i}.mp4"), i * 10, 10)
        i += 1
    os.remove(vid_name)


def main(argv=None):
    trim((sys.argv[1:] if argv is None else argv)[0])


if __name__ == "__main__":
    main()
