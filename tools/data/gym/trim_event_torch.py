#!/usr/bin/env python
"""Trim FineGYM raw videos into event-level clips with the port's trim
helper (mirrors ``tools/data/gym/trim_event.py``).

    python tools/data/gym/trim_event_torch.py [--data-root data/gym]
"""

import argparse
import json
import os
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)) + "/..")
from _trim_torch import trim_video  # noqa: E402


def main(argv=None):
    """Write ``events/<video>_<event>.mp4`` and
    ``annotations/event_annotation.json``; returns the latter's dict."""
    p = argparse.ArgumentParser()
    p.add_argument("--data-root", default="data/gym")
    args = p.parse_args(argv)
    video_root = f"{args.data_root}/videos"
    anno_root = f"{args.data_root}/annotations"
    event_root = f"{args.data_root}/events"
    os.makedirs(event_root, exist_ok=True)

    with open(f"{anno_root}/annotation.json") as f:
        annotation = json.load(f)
    videos = set(os.listdir(video_root))
    event_annotation = {}

    for k, v in annotation.items():
        if k + ".mp4" not in videos:
            print(f"video {k} has not been downloaded")
            continue
        video_path = osp.join(video_root, k + ".mp4")
        for event_id, event_anno in v.items():
            start_time, end_time = event_anno["timestamps"][0]
            event_name = f"{k}_{event_id}"
            out = osp.join(event_root, event_name + ".mp4")
            if not trim_video(video_path, out, start_time, end_time - start_time):
                print(f"Trimming of the Event {event_name} of Video {k} "
                      "Failed", flush=True)
            segments = event_anno["segments"]
            if segments is not None:
                event_annotation[event_name] = segments

    with open(f"{anno_root}/event_annotation.json", "w") as f:
        json.dump(event_annotation, f)
    return event_annotation


if __name__ == "__main__":
    main()
