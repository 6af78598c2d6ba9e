#!/usr/bin/env python
"""Trim FineGYM event clips into subaction clips with the port's trim
helper (mirrors ``tools/data/gym/trim_subaction.py``).

    python tools/data/gym/trim_subaction_torch.py [--data-root data/gym]
"""

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)) + "/..")
from _trim_torch import trim_video  # noqa: E402


def main(argv=None):
    """Write ``subactions/<event>_<subaction>.mp4`` for every subaction of
    ``annotations/event_annotation.json`` whose event clip exists."""
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", default="data/gym")
    args = p.parse_args(argv)
    anno_root = f"{args.data_root}/annotations"
    event_root = f"{args.data_root}/events"
    subaction_root = f"{args.data_root}/subactions"
    os.makedirs(subaction_root, exist_ok=True)

    with open(f"{anno_root}/event_annotation.json") as f:
        annotation = json.load(f)
    events = set(os.listdir(event_root))

    for k, v in annotation.items():
        if k + ".mp4" not in events:
            print(f"video {k[:11]} has not been downloaded or the event "
                  f"clip {k} not generated")
            continue
        video_path = osp.join(event_root, k + ".mp4")
        for subaction_id, subaction_anno in v.items():
            timestamps = subaction_anno["timestamps"]
            start_time, end_time = timestamps[0][0], timestamps[-1][1]
            subaction_name = f"{k}_{subaction_id}"
            out = osp.join(subaction_root, subaction_name + ".mp4")
            if not trim_video(video_path, out, start_time, end_time - start_time):
                print(f"Trimming of the Subaction {subaction_name} of "
                      f"Event {k} Failed", flush=True)


if __name__ == "__main__":
    main()
