#!/usr/bin/env python
"""Convert BSN/BMN proposal output json into the SSN-style formatted
proposal file with the port's tIoU (mirrors
``tools/data/activitynet/convert_proposal_format.py``).

The output follows the documented standard proposal format, as the JAX
tool's: per video the header is ``duration_second fps`` (the loader
computes ``num_frames = field1 * field2``), gt and proposal boundaries are
frame indices, labels are 1-based with 0 kept for the background. It
round-trips through ``core/ssn_utils.load_localize_proposal_file``.

    python tools/data/activitynet/convert_proposal_format_torch.py \
        [--ann-file anet_anno_val.json] \
        [--activity-index-file anet_activity_indexes_val.txt] \
        [--proposal-file results.json] \
        [--formatted-proposal-file anet_val_formatted_proposal.txt]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))

from adapt_image_models_torch.core.metrics import pairwise_temporal_iou  # noqa: E402


def dump_formatted_proposal(video_idx, video_id, duration_second, fps, gts,
                            proposals, tiou, t_overlap_self, out):
    """gts rows: [start_f, end_f, label (1-based)]; proposals rows:
    [start_f, end_f, score]."""
    out.write(f"#{video_idx}\n{video_id}\n{duration_second}\n{fps}\n{gts.shape[0]}\n")
    for gt in gts:
        out.write(f"{int(gt[2])} {int(gt[0])} {int(gt[1])}\n")
    out.write(f"{proposals.shape[0]}\n")
    best_iou = np.amax(tiou, axis=0)
    best_iou_index = np.argmax(tiou, axis=0)
    best_overlap = np.amax(t_overlap_self, axis=0)
    best_overlap_index = np.argmax(t_overlap_self, axis=0)
    for i in range(proposals.shape[0]):
        label_iou = int(gts[best_iou_index[i]][2])
        label_overlap = int(gts[best_overlap_index[i]][2])
        label = label_iou if label_iou != 0 else label_overlap
        if best_iou[i] == 0 and best_overlap[i] == 0:
            out.write(f"0 0 0 {int(proposals[i][0])} {int(proposals[i][1])}\n")
        else:
            out.write(f"{label} {best_iou[i]:.4f} {best_overlap[i]:.4f} "
                      f"{int(proposals[i][0])} {int(proposals[i][1])}\n")


def main(argv=None):
    """Write the formatted proposal file; returns its path."""
    p = argparse.ArgumentParser(description="convert proposal format")
    p.add_argument("--ann-file", default="data/ActivityNet/anet_anno_val.json")
    p.add_argument("--activity-index-file",
                   default="data/ActivityNet/anet_activity_indexes_val.txt")
    p.add_argument("--proposal-file", default="results.json")
    p.add_argument("--formatted-proposal-file", default="anet_val_formatted_proposal.txt")
    args = p.parse_args(argv)

    # 1-based: 0 stays the background / no-match sentinel
    with open(args.activity_index_file) as f:
        activity_index = {line.strip(): i + 1 for i, line in enumerate(f)}
    with open(args.ann_file) as f:
        anno_database = json.load(f)
    with open(args.proposal_file) as f:
        results = json.load(f)["results"]

    with open(args.formatted_proposal_file, "w") as out:
        for video_idx, (video_name, info) in enumerate(anno_database.items()):
            video_id = video_name[2:]
            fps = float(info["fps"])
            duration_second = info.get("duration_second", info["duration_frame"] / fps)
            # seconds -> frame indices (tIoU is scale-invariant, so the
            # matching happens in frames too)
            gts = np.array([[a["segment"][0] * fps, a["segment"][1] * fps,
                             activity_index[a["label"]]] for a in info["annotations"]])
            props = np.array([[pr["segment"][0] * fps, pr["segment"][1] * fps, pr["score"]]
                              for pr in results[video_id]])
            tiou, t_overlap = pairwise_temporal_iou(props[:, :2], gts[:, :2],
                                                    calculate_overlap_self=True)
            dump_formatted_proposal(video_idx, video_id, duration_second, fps, gts, props,
                                    tiou, t_overlap, out)
    return args.formatted_proposal_file


if __name__ == "__main__":
    main()
