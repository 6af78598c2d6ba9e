#!/usr/bin/env python
"""Model-zoo verification with the PyTorch port (mirrors
``tools/verify_zoo.py``).

For each row of ``tools/model_zoo.yml`` (the reference's released results):

1. builds the row's recipe (with the row's ``cfg_options`` and the
   command line's) and checks the published total and tunable parameter
   counts within a relative tolerance (``--param-rtol``; the model is built
   on the meta device, so this needs neither data nor a checkpoint);
2. with ``--local-pth``, loads that released checkpoint into the model on
   ``--device`` (``convert.load_checkpoint``), runs the row's test protocol
   over ``--split`` (``apis.run_evaluation``) and diffs top-1/top-5
   against the published numbers within ``--tol`` points.

The tool never downloads: a row without ``--local-pth`` is reported as
skipped, with the manifest's URL for the user to fetch. The split defaults
to ``test``, where the rows' ``cfg_options`` and the published multi-view
protocols live.

    python tools/verify_zoo_torch.py --param-check-only
    python tools/verify_zoo_torch.py --model aim_vitb16_k400_8x3x1 \
        --local-pth vitclip_base_k400.pth \
        --cfg-options data.test.ann_file=data/k400/val.txt \
                      data.test.data_prefix=data/k400/videos_val
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
MANIFEST = os.path.join(REPO, "tools", "model_zoo.yml")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="Verify released-model results (PyTorch port)")
    p.add_argument("--manifest", default=MANIFEST)
    p.add_argument("--model", default=None, help="manifest row name (default: every row)")
    p.add_argument("--local-pth", default=None, help="path to the released .pth")
    p.add_argument("--param-check-only", action="store_true",
                   help="only verify the published parameter counts")
    p.add_argument("--split", default="test", choices=["val", "test"])
    p.add_argument("--tol", type=float, default=0.3,
                   help="accuracy tolerance in percentage points")
    p.add_argument("--param-rtol", type=float, default=0.03,
                   help="relative tolerance of the parameter counts")
    p.add_argument("--device", default="cuda", help="torch device, e.g. cuda or cpu")
    p.add_argument("--out", default=None, help="dump verdicts json")
    p.add_argument("--cfg-options", nargs="+", default=[],
                   help="extra k=v config overrides (e.g. dataset paths)")
    return p.parse_args(argv)


def load_manifest(path):
    import yaml
    with open(path) as f:
        data = yaml.safe_load(f)
    return [{"dataset": dataset, **e} for dataset, entries in data.items() for e in entries]


def row_config(row, options=()):
    """The row's config dict: its recipe with the row's ``cfg_options``, then
    ``options``."""
    from adapt_image_models_torch.apis import load_config
    items = [f"{k}={v}" for k, v in (row.get("cfg_options") or {}).items()]
    return load_config(os.path.join(REPO, row["config"]), items + list(options))


def check_params(row, cfg, rtol):
    """Count the row's model (built on the meta device) against its
    published ``params_m`` and ``tunable_params_m``."""
    from adapt_image_models_torch.apis import model_config
    from adapt_image_models_torch.models import build_model
    from adapt_image_models_torch.utils.flops import count_params
    mcfg = {k: v for k, v in model_config(cfg).items() if k not in ("test_cfg", "train_cfg")}
    total, tunable, _ = count_params(build_model(mcfg, device="meta"))
    total_m, tunable_m = total / 1e6, tunable / 1e6
    ok = all(abs(got - row[key]) <= rtol * row[key]
             for got, key in ((total_m, "params_m"), (tunable_m, "tunable_params_m")))
    return {"params_m": round(total_m, 3), "tunable_params_m": round(tunable_m, 3),
            "params_ok": bool(ok)}


def verify_row(row, args):
    """The row's verdict: the parameter check, then, with ``--local-pth``,
    the accuracy check; without it the row is skipped (no download)."""
    cfg = row_config(row, args.cfg_options)
    verdict = {"name": row["name"], **check_params(row, cfg, args.param_rtol)}
    if args.param_check_only:
        return verdict
    if not args.local_pth:
        verdict.update(accuracy="skipped", url=row.get("url"))
        print(f"{row['name']}: no --local-pth; this tool downloads nothing: fetch "
              f"{row.get('url') or '(no released checkpoint)'} and pass --local-pth",
              file=sys.stderr)
        return verdict
    if not os.path.isfile(args.local_pth):
        raise FileNotFoundError(f"{row['name']}: --local-pth {args.local_pth} does not exist")

    from adapt_image_models_torch.apis import init_recognizer, run_evaluation
    model = init_recognizer(cfg, checkpoint=args.local_pth, device=args.device)
    results = run_evaluation(cfg, model=model, split=args.split,
                             metrics=("top_k_accuracy",), device=args.device)
    top1 = 100.0 * results.get("top1_acc", 0.0)
    top5 = 100.0 * results.get("top5_acc", 0.0)
    expect = row.get("expect", {})
    ok = all(abs(got - expect[key]) <= args.tol
             for got, key in ((top1, "top1"), (top5, "top5")) if key in expect)
    verdict.update(top1=round(top1, 2), top5=round(top5, 2), expect=expect,
                   accuracy_ok=bool(ok))
    return verdict


def main(argv=None):
    args = parse_args(argv)
    rows = load_manifest(args.manifest)
    if args.model:
        rows = [r for r in rows if r["name"] == args.model]
        if not rows:
            raise SystemExit(f"no manifest row named {args.model!r}")
    verdicts = []
    for row in rows:
        verdicts.append(verify_row(row, args))
        print(json.dumps(verdicts[-1]))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(verdicts, f, indent=1)
    bad = [v["name"] for v in verdicts
           if not (v["params_ok"] and v.get("accuracy_ok", True))]
    if bad:
        raise SystemExit(f"verification FAILED for: {bad}")
    skipped = sum(v.get("accuracy") == "skipped" for v in verdicts)
    print(f"all {len(verdicts)} row(s) verified" + (f" ({skipped} without a checkpoint: "
                                                   "accuracy skipped)" if skipped else ""))
    return verdicts


if __name__ == "__main__":
    main()
