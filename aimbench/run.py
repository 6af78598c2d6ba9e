"""One run of one benchmark cell of the PyTorch + CUDA port
(``adapt_image_models_torch``) on the machine it is started on.

    python3 aimbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, traffic mix, limits and metric readers are
found by name (``aimbench/spec.py``). Set-up builds the port's train step
or multi-view eval step on the card, draws the weights and a pool of host
batches from the seed and runs the first calls, which warm every shape;
then a closed loop runs for ``--seconds``; with ``--trace 1`` three short
sub-windows follow, two of them profiled. Once the program's state is freed, the plain
reference (``aimbench/reference/``) answers the same inputs and the
numbers compared are printed beside their limits: as the last lines on
standard error, and under ``compared``, the last key of the result line,
which is the last line of standard output. ``--trace 0`` reports the
cell's end-to-end metrics, ``--trace 1`` its per-layer ones. Without the
CUDA devices the cell asks for the run prints no result and exits 2; if
JAX, flax, optax or the JAX package was imported, it exits 3.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:] = [ROOT] + [p for p in sys.path if os.path.abspath(p or os.curdir) != HERE]

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "adapt_image_models_tpu")
RUNS = os.path.join(ROOT, "aimbench_runs")  # Chrome traces of the traced runs


def forbidden_modules():
    """The top-level names among ``FORBIDDEN`` that ``sys.modules`` holds,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="one run of a benchmark cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell: dict, seed: int, seconds: float, traced: bool, device="cuda",
            t_start: float = T0):
    """Run the cell; returns (result dict, numbers compared with limits)."""
    import torch
    from aimbench import cells, check, flops
    cuda = torch.device(device).type == "cuda"
    t_imported = time.perf_counter()
    if cuda:
        from adapt_image_models_torch.ops import _kernels
        _kernels.library()  # built once a checkout: the first run's compile
    t_kernels = time.perf_counter()
    c = cells.make(cell, seed, device)
    c.setup()
    setup_s = time.perf_counter() - t_start
    c.window(seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    t_window = time.perf_counter()
    if cuda:
        from adapt_image_models_torch import ops
        print(json.dumps({"calls": c.measured["window"]["calls"],
                          "launch_counts": ops.launch_counts(),
                          "core_launch_counts": ops.core_launch_counts()}))
    if traced:
        os.makedirs(RUNS, exist_ok=True)
        c.trace(Path(RUNS), f"{cell['name']}.{seed}")
    t_trace = time.perf_counter()
    c.release()
    ref = c.reference("fp32")
    correct, shown = check.verdict(c.numbers(c.program, ref), cell["limits"])
    phases = {"imports": t_imported - t_start, "kernels": t_kernels - t_imported,
              **c.measured["setup"]}
    print(f"aimbench: set-up {setup_s:.3f} s ("
          + ", ".join(f"{k} {v:.3f}" for k, v in phases.items())
          + f"), window {c.measured['window']['seconds']:.3f} s, "
          f"trace {t_trace - t_window:.3f} s, reference {time.perf_counter() - t_trace:.3f} s",
          file=sys.stderr)

    m = cell["config"]["model"]
    per_unit = (flops.train_flops(m) if c.kind == "train"
                else int(cell["traffic"]["views"]) * flops.forward_flops(m))
    ctx = {"kind": c.kind, "setup_s": setup_s, "window": c.measured["window"],
           "peak_bytes": peak, "flops_per_unit": per_unit, "peak_flops": flops.PEAK_FLOPS,
           "timeline": c.measured.get("timeline"), "rooflines": c.measured.get("rooflines"),
           "dispatch_ms": c.measured.get("dispatch_ms")}
    metrics = {}
    for entry in cell["per_layer" if traced else "end_to_end"]:
        value = cell["readers"][entry["name"]](ctx)
        if value is not None:
            metrics[entry["name"]] = {"value": value, "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": c.measured["window"]["units"], "failed": 0,
              "metrics": metrics, "device": dev}
    timeline = c.measured.get("timeline")
    if traced and timeline:
        dev.update(busy_s=timeline["busy_s"], window_s=timeline["window_s"])
        result["breakdown"] = {"device_ops": timeline["device_ops"],
                               "idle_gaps": timeline["idle_gaps"]}
    result["compared"] = shown
    return result, shown


def main(argv=None) -> int:
    args = parse_args(argv)
    from aimbench import spec
    cell = spec.resolve(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"aimbench: {args.workload} needs {cell['chips']} CUDA device(s), found {found}",
              file=sys.stderr)
        return 2
    result, shown = measure(cell, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"aimbench: the run imported {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, item in shown.items():
        print(f"compared {name}: {item['value']!r} limit {item['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
