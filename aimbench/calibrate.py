"""The readings a cell's limits are set from, in one process on the card:

    python3 aimbench/calibrate.py --workload <cell> [--seeds <n> ...] \
        [--control-seeds <n> ...] [--readings earlier.jsonl ...] [--out readings.jsonl]

For each of ``--seeds`` the program's side of the check (the set-up's
first calls of the timed entry, as a run makes them) against the plain
reference; for each of ``--control-seeds`` the control, the reference
computed with float8 e4m3 products in the program's place, and the faults
this kind of cell can have, planted in the reference put in the program's
place: for a train cell a step that returns its state unchanged, the
loss taken over half of each batch and every learning rate 1.1 times, for
an eval cell an answer altered and the last view left out of the average
(a missing answer reads infinite and needs no run). Prints a JSON line a
reading, then for each number its lower reading (the largest of the
program's), its upper reading (the least of the control's and the
faults' that read high enough: ``summarize``) and the limit
``check.limit_from`` puts between, over these readings and those of
``--readings``; without seeds it only summarizes those, and needs no card.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]


# the keys of a reading that are not numbers compared
NOT_NUMBERS = ("seed", "what", "program_s", "reference_s", "leaves_left_out")


def readings(cell: dict, seeds, control_seeds, device="cuda", emit=print):
    """Yield every reading as a dict: {"seed", "what", numbers...}."""
    import torch
    from aimbench import cells, check
    for seed in seeds:
        c = cells.make(cell, seed, device)
        t0 = time.perf_counter()
        c.setup()
        prog = c.program
        c.release()
        t1 = time.perf_counter()
        ref = c.reference("fp32")
        t2 = time.perf_counter()
        extra = ({"leaves_left_out": sorted(set(ref["grad"]) - set(check.moved_leaves(ref["grad"])))}
                 if c.kind == "train" else {})
        emit({"seed": seed, "what": "program", **c.numbers(prog, ref),
              "program_s": t1 - t0, "reference_s": t2 - t1, **extra})
        del c, prog, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
    for seed in control_seeds:
        c = cells.make(cell, seed, device)
        c.draw()
        ref = c.reference("fp32")
        as_prog = cells.as_program(c.kind, ref)
        emit({"seed": seed, "what": "control fp8",
              **c.numbers(cells.as_program(c.kind, c.reference("fp8")), ref)})
        if c.kind == "train":
            emit({"seed": seed, "what": "fault unchanged", **c.numbers(cells.unchanged(as_prog), ref)})
            emit({"seed": seed, "what": "fault half batch", **c.numbers(c.reference("half"), ref)})
            emit({"seed": seed, "what": "fault lr x1.1", **c.numbers(c.reference("lr1.1"), ref)})
        else:
            emit({"seed": seed, "what": "fault altered answer",
                  **c.numbers(cells.altered(as_prog), ref)})
            emit({"seed": seed, "what": "fault view left out",
                  **c.numbers(cells.as_program(c.kind, c.reference("view")), ref)})
        del c, ref, as_prog
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def summarize(rows):
    """{number: {"lower", "upper", "limit"}} over the readings: the upper
    reading is the least of the control's and the faults' that read at
    least three times the lower (ten times for a fault, but for a state
    left unchanged)."""
    from aimbench.check import limit_from
    keys = [k for k in rows[0] if k not in NOT_NUMBERS]
    out = {}
    for k in keys:
        lower = max(r[k] for r in rows if r["what"] == "program")
        by_what = {}
        for r in rows:
            if r["what"] != "program":
                by_what.setdefault(r["what"], []).append(r[k])
        # a control or a fault counts only where it reads high on every seed
        upper = min((min(v) for w, v in by_what.items()
                     if min(v) >= (3 if w in ("control fp8", "fault unchanged") else 10) * lower),
                    default=None)
        out[k] = {"lower": lower, "upper": upper, "limit": limit_from(lower, upper)}
    return out


def earlier(paths, workload):
    """The readings of ``workload`` in JSON-lines files: this script's own
    lines, and result lines of ``run.py`` that carry their ``workload``
    beside ``compared`` (their numbers count as the program's)."""
    rows = []
    for path in paths:
        with open(path) as f:
            for line in f:
                r = json.loads(line)
                if r.get("workload") != workload or "summary" in r:
                    continue
                if "compared" in r:
                    r = {"seed": r.get("seed"), "what": "program",
                         **{k: v["value"] for k, v in r["compared"].items()}}
                rows.append({k: v for k, v in r.items() if k != "workload"})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--readings", nargs="*", default=[],
                   help="JSON-lines files of earlier readings to summarize with the new")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    from aimbench import spec
    cell = spec.resolve(args.workload)
    rows = earlier(args.readings, args.workload)
    if args.seeds or args.control_seeds:
        import torch
        if not torch.cuda.is_available():
            print("aimbench: no CUDA device", file=sys.stderr)
            return 2
        from adapt_image_models_torch.ops import _kernels
        _kernels.library()
    out = open(args.out, "a") if args.out else None

    def emit(row):
        rows.append(row)
        line = json.dumps({"workload": args.workload, **row})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    readings(cell, args.seeds, args.control_seeds, emit=emit)
    print(json.dumps({"workload": args.workload, "summary": summarize(rows)}), flush=True)
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
