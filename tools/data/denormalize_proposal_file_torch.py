#!/usr/bin/env python
"""Denormalize SSN proposal files with the port's proposal reader (mirrors
``tools/data/denormalize_proposal_file.py``): normalized [0, 1] gt and
proposal extents become frame indices, from the frame counts found under
the rawframes root, in the multi-video proposal format that
``core/ssn_utils.load_localize_proposal_file`` parses.

    python tools/data/denormalize_proposal_file_torch.py \
        <normalized_proposal_list.txt> --frame-root data/.../rawframes \
        [--level 1|2] [--out file]
"""

import argparse
import importlib.util
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))

from adapt_image_models_torch.core.ssn_utils import load_localize_proposal_file  # noqa: E402


def process_norm_proposal_file(norm_proposal_file, frame_dict, out_file=None):
    """Write the denormalized file (by default the input's name without
    ``normalized_``); returns its path."""
    out_file = out_file or norm_proposal_file.replace("normalized_", "")
    norm_proposals = load_localize_proposal_file(norm_proposal_file)

    chunks = []
    for idx, (video_id, _, gts, proposals) in enumerate(norm_proposals):
        frame_path, num_frames = frame_dict[video_id][:2]
        frame_path = osp.basename(frame_path)
        gt = [[int(x[0]), int(float(x[1]) * num_frames), int(float(x[2]) * num_frames)]
              for x in gts]
        prop = [[int(x[0]), float(x[1]), float(x[2]), int(float(x[3]) * num_frames),
                 int(float(x[4]) * num_frames)] for x in proposals]
        gt_dump = "".join("{} {} {}\n".format(*x) for x in gt)
        prop_dump = "".join("{} {:.04f} {:.04f} {} {}\n".format(*x) for x in prop)
        chunks.append(f"# {idx}\n{frame_path}\n{num_frames}\n1\n"
                      f"{len(gt)}\n{gt_dump}{len(prop)}\n{prop_dump}")
    with open(out_file, "w") as f:
        f.writelines(chunks)
    return out_file


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("norm_proposal_file")
    p.add_argument("--frame-root", required=True, help="rawframes root to count frames under")
    p.add_argument("--level", type=int, default=1, choices=[1, 2])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    # the frame counter of the data-prep scripts (no package import)
    spec = importlib.util.spec_from_file_location(
        "parse_file_list", osp.join(osp.dirname(osp.abspath(__file__)), "parse_file_list.py"))
    pfl = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(pfl)
    frame_dict = pfl.parse_directory(args.frame_root, level=args.level)
    out = process_norm_proposal_file(args.norm_proposal_file, frame_dict, args.out)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
