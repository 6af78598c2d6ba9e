"""The traced run's readings, from ``torch.profiler``'s Chrome trace.

Two short profiled sub-windows follow the measured window. The first runs
the steps as the window does and gives the device's busy time (the union of
its kernels, copies and fills), the traced window's length, the device
operations that took most time and the longest idle gaps, each labelled by
what the host's main thread was in at the gap's middle. The second runs
them under a pass-through dispatch mode of torch's own, under which the
port's kernel launchers go through their registered ``aim_port`` ops
(``ops/_kernels.py``: the same CUDA bodies), so that the profiler records
each launch with its argument shapes and scalars; each kernel is tied to
the outermost ``aim_port`` op whose interval holds its launch, and a
family's roofline share is the sum of the ops' least times
(``aimbench/bounds.py``) over the sum of their kernels' device time.
"""

from __future__ import annotations

import bisect
import json
from typing import Callable, Dict, List, Optional

import torch

from aimbench import bounds

WINDOW = "aimbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation", "python_function")
ITEMSIZE = {"c10::BFloat16": 2, "c10::Half": 2, "float": 4, "double": 8, "int": 4,
            "long int": 8, "unsigned char": 1, "bool": 1}
# the launches each roofline family reads
FAMILIES = {
    "gemm": ("aim_port::gemm",),
    "attn": ("aim_port::spatial_attention", "aim_port::spatial_attention_bwd",
             "aim_port::temporal_attention", "aim_port::temporal_attention_bwd",
             "aim_port::temporal_segment", "aim_port::temporal_segment_bwd",
             "aim_port::flash_attention"),
}


def launch_mode():
    """A pass-through ``TorchDispatchMode`` defined in torch, so that the
    port's launchers take their registered ops (``_kernels.traced``)."""
    from torch.utils._python_dispatch import BaseTorchDispatchMode
    return BaseTorchDispatchMode()


def profile(run: Callable[[int], None], n: int, path: str, shapes: bool = False) -> dict:
    """Run ``run(i)`` for i < n under the profiler, synchronise, write the
    Chrome trace to ``path`` and return it parsed."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts, record_shapes=shapes) as prof:
        with torch.profiler.record_function(WINDOW):
            for i in range(n):
                run(i)
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
    with open(path) as f:
        return json.load(f)


def _events(trace: dict) -> List[dict]:
    return [e for e in trace.get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]


def _window(events: List[dict]) -> Optional[dict]:
    marks = [e for e in events if e.get("cat") == "user_annotation" and e["name"] == WINDOW]
    return marks[0] if marks else None


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def short_name(name: str, limit: int = 90) -> str:
    """A kernel's name without ``void``, anonymous namespaces, template
    arguments and parameters."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ").strip()
    cut = min((name.index(sep) for sep in "<(" if sep in name[1:]), default=len(name))
    return name[:max(cut, 1)][:limit].strip()


def timeline(trace: dict) -> Optional[dict]:
    """busy_s, window_s and the breakdown of the plain sub-window: the ten
    device operations of most total time and the ten longest idle gaps,
    each [name, seconds]."""
    events = _events(trace)
    win = _window(events)
    if win is None:
        return None
    w0, w1 = float(win["ts"]), float(win["ts"]) + float(win["dur"])
    device = [e for e in events if e.get("cat") in DEVICE_CATS]
    spans = _merge((max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]), w1))
                   for e in device if float(e["ts"]) < w1 and float(e["ts"]) + float(e["dur"]) > w0)
    busy = sum(b - a for a, b in spans)
    if busy <= 0:
        return None
    by_name: Dict[str, float] = {}
    for e in device:
        key = short_name(e["name"])
        by_name[key] = by_name.get(key, 0.0) + float(e["dur"]) * 1e-6
    host = [e for e in events if e.get("cat") in HOST_CATS and e.get("tid") == win.get("tid")
            and e is not win]
    gaps, edge = [], w0
    for a, b in spans + [[w1, w1]]:
        if a > edge:
            gaps.append((edge, a))
        edge = max(edge, b)
    labelled = []
    for a, b in sorted(gaps, key=lambda g: g[0] - g[1])[:10]:
        mid = 0.5 * (a + b)
        inside = [e for e in host if float(e["ts"]) <= mid <= float(e["ts"]) + float(e["dur"])]
        label = min(inside, key=lambda e: float(e["dur"]))["name"] if inside else "python"
        labelled.append([f"host: {label}"[:90], (b - a) * 1e-6])
    return {
        "busy_s": busy * 1e-6, "window_s": (w1 - w0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_name.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": labelled,
    }


def _concrete(args: dict, i: int):
    values = args.get("Concrete Inputs") or []
    return values[i] if i < len(values) else ""


def _numel(dims) -> int:
    n = 1
    for s in dims:
        n *= int(s)
    return n


def op_work(name: str, args: dict):
    """(FLOPs, bytes) an ``aim_port`` launch requires, from its recorded
    shapes, dtypes and scalars; None where they were not recorded."""
    dims = args.get("Input Dims") or []
    types = args.get("Input type") or []
    if not dims:
        return None
    flag = lambda i: _concrete(args, i) == "True"  # noqa: E731
    num = lambda i: int(_concrete(args, i))  # noqa: E731
    try:
        if name == "aim_port::gemm":
            (m, k), w = dims[0], dims[1]
            n = w[1] if flag(2) else w[0]
            f32_reads = sum(1 for i in (5, 8) if dims[i])  # aux, res_f32
            has_outs = _concrete(args, 13) != ""
            out_bytes = (4 * flag(13) + 2 * flag(14)) if has_outs else 2
            flops, nbytes = bounds.gemm_work(m, k, n, f32_reads, out_bytes, bool(dims[3]))
            for i in (11, 12):  # res_bf16, bias2
                if dims[i]:
                    nbytes += _numel(dims[i]) * ITEMSIZE.get(types[i] if i < len(types) else "", 2)
            return flops, nbytes
        if name == "aim_port::flash_attention":
            b, h, length, hd = dims[0]
            act = 2 * b * h * length * hd
            return 4 * b * h * length * length * hd, 4 * act
        rows, width3 = dims[0]
        d = width3 // 3
        heads = d // 64
        if name == "aim_port::spatial_attention":
            return bounds.spatial_core_work(num(1), heads, num(2))
        if name == "aim_port::spatial_attention_bwd":
            flops, nbytes = bounds.spatial_core_work(num(2), heads, num(3), backward=True)
            return flops, nbytes + 2 * rows * d * flag(4)
        if name == "aim_port::temporal_attention":
            return bounds.temporal_fwd_work(num(1), num(2), num(3), heads)
        if name == "aim_port::temporal_segment":
            return bounds.segment_core_work(num(1), num(2), num(3), d)
        if name in ("aim_port::temporal_attention_bwd", "aim_port::temporal_segment_bwd"):
            flops, nbytes = bounds.temporal_bwd_work(num(2), num(3), num(4), heads,
                                                     segment=name.endswith("segment_bwd"))
            return flops, nbytes + 2 * rows * d * flag(5)
    except (ValueError, IndexError, TypeError):
        return None
    return None


def rooflines(trace: dict) -> Dict[str, dict]:
    """{family: {"bound_s", "device_s", "launches"}} of the shapes
    sub-window; a family is left out where it had no launch, where a launch
    could not be tied to a kernel or where its shapes were not recorded."""
    events = _events(trace)
    ops = sorted((e for e in events if e.get("cat") == "cpu_op"
                  and e["name"].startswith("aim_port::")), key=lambda e: float(e["ts"]))
    outer, end = [], -1.0
    for e in ops:  # the outermost aim_port ops (a launcher may call another)
        if float(e["ts"]) >= end:
            outer.append(e)
            end = float(e["ts"]) + float(e["dur"])
    starts_by_tid: Dict[int, list] = {}
    for i, e in enumerate(outer):
        starts_by_tid.setdefault(e.get("tid"), []).append((float(e["ts"]), i))
    launch_ts = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {}):
            launch_ts[e["args"]["correlation"]] = (float(e["ts"]), e.get("tid"))
    device_us = [0.0] * len(outer)
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        launch = launch_ts.get(e.get("args", {}).get("correlation"))
        if launch is None:
            continue
        ts, tid = launch
        starts = starts_by_tid.get(tid, [])
        j = bisect.bisect_right(starts, (ts, float("inf"))) - 1
        if j >= 0:
            op = outer[starts[j][1]]
            if ts <= float(op["ts"]) + float(op["dur"]):
                device_us[starts[j][1]] += float(e["dur"])
    out = {}
    for family, names in FAMILIES.items():
        members = [i for i, e in enumerate(outer) if e["name"] in names]
        works = [op_work(outer[i]["name"], outer[i].get("args", {})) for i in members]
        if not members or any(w is None for w in works) or any(device_us[i] <= 0 for i in members):
            continue
        out[family] = {
            "bound_s": sum(bounds.bound_of(*w)[0] for w in works) * 1e-3,
            "device_s": sum(device_us[i] for i in members) * 1e-6,
            "launches": len(members),
        }
    return out
