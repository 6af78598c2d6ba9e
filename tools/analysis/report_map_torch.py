#!/usr/bin/env python
"""Report detection mAP for an ActivityNet proposal file with the PyTorch
port's evaluator (mirrors ``tools/analysis/report_map.py``).

Assigns an action label to every class-agnostic proposal and evaluates
interpolated detection mAP over tIoU 0.5:0.05:0.95.

Label assignment (``--cls``):

* ``cuhk17_top1``: each video's proposals take the top-1 class of the
  CUHK-17 challenge predictions, read from a local ``--cls-file`` (the tool
  downloads nothing);
* ``label_in_file``: the proposals already carry a ``label`` field.

    python tools/analysis/report_map_torch.py --proposal results.json \
        --gt anet_anno_val.json [--cls label_in_file]
"""

import argparse
import json
import os
import sys

import numpy as np

# this folder holds profile.py, whose name shadows the standard library's
# module (torch's compiler imports cProfile): the repo root takes its place
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:] = [os.path.dirname(os.path.dirname(HERE))] + [
    p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


def cuhk17_top1(proposal_file, cls_file, det_output):
    """Write ``det_output``: the proposals of ``proposal_file``, each with
    the top-1 label of its video in ``cls_file``."""
    if not os.path.exists(cls_file):
        raise FileNotFoundError(
            f"{cls_file} not found: the CUHK-17 predictions (cuhk_anet17_pred.json) "
            "must be local; pass --cls-file")
    with open(proposal_file) as f:
        proposal = json.load(f)
    with open(cls_file) as f:
        cuhk_pred = json.load(f)["results"]
    results = proposal["results"]
    for vid, props in results.items():
        top1 = max(cuhk_pred[vid], key=lambda x: x["score"])
        results[vid] = [dict(label=top1["label"], **item) for item in props]
    with open(det_output, "w") as f:
        json.dump(proposal, f)


def main(argv=None):
    p = argparse.ArgumentParser(description="ActivityNet detection mAP (PyTorch port)")
    p.add_argument("--proposal", required=True, help="proposal file")
    p.add_argument("--gt", default="data/ActivityNet/anet_anno_val.json")
    p.add_argument("--cls", default="cuhk17_top1", choices=["cuhk17_top1", "label_in_file"])
    p.add_argument("--cls-file", default="cuhk_anet17_pred.json",
                   help="external classification predictions (cuhk17_top1)")
    p.add_argument("--det-output", default="det_result.json")
    args = p.parse_args(argv)

    det_file = args.proposal
    if args.cls == "cuhk17_top1":
        cuhk17_top1(args.proposal, args.cls_file, args.det_output)
        det_file = args.det_output

    from adapt_image_models_torch.core.eval_detection import ActivityNetDetection
    det = ActivityNetDetection(args.gt, det_file, tiou_thresholds=np.linspace(0.5, 0.95, 10),
                               verbose=True)
    m_ap, average_m_ap = det.evaluate()
    print("[RESULTS] Performance on ActivityNet detection task.\n"
          f"mAP: {m_ap}\nAverage-mAP: {average_m_ap}")
    return m_ap, average_m_ap


if __name__ == "__main__":
    main()
