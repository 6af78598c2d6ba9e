#!/usr/bin/env python
"""BSN Proposal-Generation-Module (PGM) on the PyTorch port's
``core/proposals.py`` (mirrors ``tools/misc/bsn_proposal_generation.py``):
TEM results -> candidate proposals -> boundary-sensitive proposal features.

Stage interop uses the reference CSV layout: TEM results
``<dir>/<video>.csv`` with header ``action,start,end,tmin,tmax``; proposal
files with header ``tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa``;
features as ``.npy``.
"""

import argparse
import json
import os
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__)))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="BSN PGM (PyTorch port)")
    p.add_argument("ann_file", nargs="?", default=None,
                   help="ActivityNet-style annotation json (or use --config)")
    p.add_argument("--config", default=None,
                   help="PGM recipe (reference configs/localization/bsn/"
                        "bsn_pgm_400x100_activitynet_feature.py) supplying "
                        "dirs + sampling params; CLI flags override it")
    p.add_argument("--tem-results-dir", default=None)
    p.add_argument("--pgm-proposals-dir", default=None)
    p.add_argument("--pgm-features-dir", default=None)
    p.add_argument("--peak-threshold", type=float, default=None)
    p.add_argument("--bsp-boundary-ratio", type=float, default=None)
    p.add_argument("--num-sample-start", type=int, default=None)
    p.add_argument("--num-sample-end", type=int, default=None)
    p.add_argument("--num-sample-action", type=int, default=None)
    p.add_argument("--num-sample-interp", type=int, default=None)
    p.add_argument("--top-k", type=int, default=None)
    p.add_argument("--mode", choices=["proposals", "features", "both"],
                   default="both")
    p.add_argument("--split", choices=["train", "val", "test"],
                   default="val",
                   help="with --config: pick ann_file_<split> and the "
                        "matching pgm_features cfg (the reference generates "
                        "train BSP features with pgm_features_train_cfg — "
                        "top_k 500 vs the test cfg's 1000)")
    args = p.parse_args(argv)

    defaults = dict(peak_threshold=0.5, bsp_boundary_ratio=0.2,
                    num_sample_start=8, num_sample_end=8,
                    num_sample_action=16, num_sample_interp=3, top_k=1000)
    if args.config:
        from adapt_image_models_torch.config.config import Config
        cfg = Config.fromfile(args.config)
        pp = dict(cfg.get("pgm_proposals_cfg", {}))
        feat_key = ("pgm_features_train_cfg" if args.split == "train"
                    else "pgm_features_test_cfg")
        pf = dict(cfg.get(feat_key, {}))
        defaults.update(peak_threshold=pp.get(
            "peak_threshold", defaults["peak_threshold"]))
        for k in ("bsp_boundary_ratio", "num_sample_start",
                  "num_sample_end", "num_sample_action",
                  "num_sample_interp", "top_k"):
            if k in pf:
                defaults[k] = pf[k]
        args.ann_file = args.ann_file or cfg.get(f"ann_file_{args.split}")
        args.tem_results_dir = (args.tem_results_dir
                                or cfg.get("tem_results_dir"))
        args.pgm_proposals_dir = (args.pgm_proposals_dir
                                  or cfg.get("pgm_proposals_dir"))
        args.pgm_features_dir = (args.pgm_features_dir
                                 or cfg.get("pgm_features_dir"))
    for k, v in defaults.items():
        if getattr(args, k) is None:
            setattr(args, k, v)
    for k in ("ann_file", "tem_results_dir", "pgm_proposals_dir",
              "pgm_features_dir"):
        if getattr(args, k) is None:
            p.error(f"{k.replace('_', '-')} required (flag or --config)")
    return args


PROPOSAL_HEADER = "tmin,tmax,tmin_score,tmax_score,score,match_iou,match_ioa"


def main(argv=None):
    from adapt_image_models_torch.core.proposals import (
        generate_bsp_feature, generate_candidate_proposals,
    )

    args = parse_args(argv)
    with open(args.ann_file) as f:
        anno = json.load(f)

    os.makedirs(args.pgm_proposals_dir, exist_ok=True)
    os.makedirs(args.pgm_features_dir, exist_ok=True)

    for video_name, info in anno.items():
        tem_path = osp.join(args.tem_results_dir, video_name + ".csv")
        if not osp.exists(tem_path):
            print(f"skip {video_name}: no TEM results")
            continue
        tem = np.loadtxt(tem_path, dtype=np.float32, delimiter=",",
                         skiprows=1)
        action, start, end = tem[:, 0], tem[:, 1], tem[:, 2]

        # gt segments in corrected relative time (reference bsn_utils.py:94-104)
        dur_frame = info.get("duration_frame", 0)
        dur_sec = float(info.get("duration_second", 1.0))
        feat_frame = info.get("feature_frame", dur_frame)
        corrected = (float(feat_frame) / dur_frame * dur_sec
                     if dur_frame else dur_sec)
        gts = np.asarray([a["segment"] for a in info.get("annotations", [])],
                         np.float32).reshape(-1, 2) / max(corrected, 1e-8)

        prop_path = osp.join(args.pgm_proposals_dir, video_name + ".csv")
        if args.mode in ("proposals", "both"):
            props = generate_candidate_proposals(start, end,
                                                 args.peak_threshold, gts)
            np.savetxt(prop_path, props, delimiter=",", fmt="%.6f",
                       header=PROPOSAL_HEADER, comments="")
            print(f"{video_name}: {len(props)} proposals")
        if args.mode in ("features", "both"):
            props = np.loadtxt(prop_path, dtype=np.float32, delimiter=",",
                               skiprows=1).reshape(-1, 7)
            feats = generate_bsp_feature(
                props, action,
                bsp_boundary_ratio=args.bsp_boundary_ratio,
                num_sample_start=args.num_sample_start,
                num_sample_end=args.num_sample_end,
                num_sample_action=args.num_sample_action,
                num_sample_interp=args.num_sample_interp,
                top_k=args.top_k)
            np.save(osp.join(args.pgm_features_dir, video_name + ".npy"),
                    feats)
            print(f"{video_name}: bsp features {feats.shape}")


if __name__ == "__main__":
    main()
