#!/usr/bin/env python
"""Training-log analysis of the PyTorch port's train log (mirrors
``tools/analysis/analyze_logs.py``).

Parses the lines ``apis/train.py`` logs through ``utils/logger.py``
(``Epoch [e][i/n] [source: .. shape: ..] lr: .. loss: .. top1: .. top5: ..
clips/s: ..``, after the logger's time, name and level) and reports the
throughput of each epoch, plots curves (matplotlib if available) or dumps
the rows as json. An OmniSource step's row also names its ``source``.

    python tools/analysis/analyze_logs_torch.py cal_train_time <work_dir>/train.log
    python tools/analysis/analyze_logs_torch.py plot_curve <log> --keys loss top1
"""

import argparse
import json
import re
import sys
from collections import defaultdict

LINE_RE = re.compile(
    r"Epoch \[(\d+)\]\[(\d+)/(\d+)\] (?:source: (\S+) .*?)?lr: ([\d.eE+-]+) "
    r"loss: ([\d.eE+-]+) top1: ([\d.eE+-]+) top5: ([\d.eE+-]+)"
    r"(?: clips/s: ([\d.eE+-]+))?")


def parse_log(path):
    """The train log's step rows, in order."""
    rows = []
    with open(path) as f:
        for line in f:
            m = LINE_RE.search(line)
            if m:
                row = dict(epoch=int(m.group(1)), iter=int(m.group(2)),
                           total_iters=int(m.group(3)), lr=float(m.group(5)),
                           loss=float(m.group(6)), top1=float(m.group(7)),
                           top5=float(m.group(8)),
                           clips_per_s=float(m.group(9)) if m.group(9) else None)
                if m.group(4):
                    row["source"] = m.group(4)
                rows.append(row)
    return rows


def cal_train_time(rows):
    by_epoch = defaultdict(list)
    for r in rows:
        if r["clips_per_s"]:
            by_epoch[r["epoch"]].append(r["clips_per_s"])
    for e in sorted(by_epoch):
        v = by_epoch[e]
        print(f"epoch {e}: mean {sum(v) / len(v):.1f} clips/s over {len(v)} logs")


def plot_curve(rows, keys, out):
    series = {k: [(i, r[k]) for i, r in enumerate(rows) if r.get(k) is not None]
              for k in keys}
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        for k, pts in series.items():
            plt.plot([p[0] for p in pts], [p[1] for p in pts], label=k)
        plt.legend()
        plt.xlabel("log step")
        plt.savefig(out or "curves.png")
        print(f"saved {out or 'curves.png'}")
    except ImportError:
        print(json.dumps({k: v[-5:] for k, v in series.items()}, indent=1))
        print("(matplotlib unavailable; printed the last 5 points per key)")


def main(argv=None):
    p = argparse.ArgumentParser(description="Analyse a train log (PyTorch port)")
    p.add_argument("task", choices=["cal_train_time", "plot_curve", "dump_json"])
    p.add_argument("log")
    p.add_argument("--keys", nargs="+", default=["loss"])
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    rows = parse_log(args.log)
    if not rows:
        print("no parseable log lines found")
        sys.exit(1)
    if args.task == "cal_train_time":
        cal_train_time(rows)
    elif args.task == "plot_curve":
        plot_curve(rows, args.keys, args.out)
    else:
        print(json.dumps(rows, indent=1))
    return rows


if __name__ == "__main__":
    main()
