#!/usr/bin/env python
"""Extract RGB (and optical-flow) rawframes from videos with the port's
readers (mirrors ``tools/data/build_rawframes.py``): the C++ decoder or
OpenCV decodes RGB, OpenCV's Farneback gives the flow, all on the host CPU.

    python tools/data/build_rawframes_torch.py SRC_DIR OUT_DIR \
        [--task rgb|flow|both] [--level 1|2] [--ext mp4] \
        [--new-short 256 | --new-width W --new-height H] \
        [--num-worker 8] [--resume]

Layout: ``SRC_DIR/(class/)video.ext`` -> ``OUT_DIR/(class/)video/
img_00001.jpg`` (+ ``flow_x_00001.jpg`` / ``flow_y_00001.jpg``), the
naming ``RawframeDataset`` and ``FlowFrameReader`` read. Workers are
spawned processes; ``--num-worker 1`` extracts in this process.
"""

import argparse
import glob
import os
import os.path as osp
import sys
import multiprocessing

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

FLOW_BOUND = 20.0  # mmaction/denseflow convention: clip to [-20, 20] -> uint8


def quantize_flow(flow: np.ndarray) -> np.ndarray:
    """(H, W, 2) float flow -> uint8 by the reference's bound-20 mapping."""
    q = (flow + FLOW_BOUND) * (255.0 / (2 * FLOW_BOUND))
    return np.clip(np.round(q), 0, 255).astype(np.uint8)


def _resize(img, args):
    import cv2
    if args.new_short > 0:
        from adapt_image_models_torch.data.video_reader import resize_short_side
        return resize_short_side(img, args.new_short)
    if args.new_width > 0 and args.new_height > 0:
        return cv2.resize(img, (args.new_width, args.new_height),
                          interpolation=cv2.INTER_LINEAR)
    return img


def extract_one(task):
    """(video_path, out_dir, args) -> (video, frame count; -1 when resumed
    past it, 0 on failure)."""
    import cv2
    video, out_dir, args = task
    os.makedirs(out_dir, exist_ok=True)
    done_marker = osp.join(out_dir, ".done")
    if args.resume and osp.exists(done_marker):
        return video, -1
    try:
        from adapt_image_models_torch.data.video_reader import open_video
        reader = open_video(video)
        n = reader.num_frames
        prev_gray = None
        for i in range(n):
            frame = _resize(reader.get_frames([i])[0], args)  # RGB
            bgr = cv2.cvtColor(frame, cv2.COLOR_RGB2BGR)
            if args.task in ("rgb", "both"):
                cv2.imwrite(osp.join(out_dir, f"img_{i + 1:05d}.jpg"), bgr)
            if args.task in ("flow", "both"):
                gray = cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY)
                if prev_gray is not None:
                    flow = cv2.calcOpticalFlowFarneback(
                        prev_gray, gray, None, 0.5, 3, 15, 3, 5, 1.2, 0)
                    q = quantize_flow(flow)
                    cv2.imwrite(osp.join(out_dir, f"flow_x_{i:05d}.jpg"), q[..., 0])
                    cv2.imwrite(osp.join(out_dir, f"flow_y_{i:05d}.jpg"), q[..., 1])
                prev_gray = gray
        reader.close()
        with open(done_marker, "w") as f:
            f.write(str(n))
        return video, n
    except Exception as e:  # noqa: BLE001 -- one bad video does not stop the rest
        print(f"FAILED {video}: {e}", file=sys.stderr)
        return video, 0


def main(argv=None):
    """Extract every video of the tree; returns [(video, frame count)]."""
    p = argparse.ArgumentParser()
    p.add_argument("src_dir")
    p.add_argument("out_dir")
    p.add_argument("--task", default="rgb", choices=["rgb", "flow", "both"])
    p.add_argument("--level", type=int, default=2, choices=[1, 2])
    p.add_argument("--ext", default="mp4")
    p.add_argument("--new-width", type=int, default=0)
    p.add_argument("--new-height", type=int, default=0)
    p.add_argument("--new-short", type=int, default=0)
    p.add_argument("--num-worker", type=int, default=8)
    p.add_argument("--resume", action="store_true")
    args = p.parse_args(argv)

    pattern = osp.join(args.src_dir, *("*",) * args.level) + "." + args.ext
    videos = sorted(glob.glob(pattern))
    print(f"{len(videos)} videos under {args.src_dir}")
    tasks = [(v, osp.join(args.out_dir, osp.relpath(osp.splitext(v)[0], args.src_dir)), args)
             for v in videos]
    if args.num_worker <= 1:
        results = [extract_one(t) for t in tasks]
    else:
        with multiprocessing.get_context("spawn").Pool(args.num_worker) as pool:
            results = pool.map(extract_one, tasks)
    ok = sum(1 for _, n in results if n != 0)
    print(f"done: {ok}/{len(videos)} ok")
    return results


if __name__ == "__main__":
    main()
