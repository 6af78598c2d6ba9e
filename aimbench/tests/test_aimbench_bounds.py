"""The frozen copy of the kernel bounds (``aimbench/bounds.py``) against
``tools/kernel_bounds_torch.py`` at PERF.md's shapes, and the reading of an
``aim_port`` launch's recorded arguments (``aimbench/trace.py::op_work``)."""

import importlib.util
import os

from tiny_cells import ROOT
from aimbench import bounds, trace

_spec = importlib.util.spec_from_file_location(
    "kernel_bounds_torch", os.path.join(ROOT, "tools", "kernel_bounds_torch.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def test_constants():
    assert (bounds.PEAK_FLOPS, bounds.PEAK_BYTES) == (tool.PEAK_FLOPS, tool.PEAK_BYTES) == (
        989e12, 3.35e12)


def test_gemm_cores_and_bound():
    for label, m, k, n, layout, epilogue in tool.GEMM_SHAPES:
        f32_reads = sum(e in ("aux", "res_f32") for e in epilogue)
        out_bytes = 4 if "out_f32" in epilogue else 2
        work = bounds.gemm_work(m, k, n, f32_reads, out_bytes, "bias" in epilogue)
        assert work == tool.gemm_shape_work(m, k, n, epilogue), label
        assert bounds.bound_of(*work) == tool.bound_of(*work)
    for f, h, length in tool.SPATIAL_SHAPES:
        for back in (False, True):
            assert bounds.spatial_core_work(f, h, length, back) == tool.spatial_core_work(
                f, h, length, back)
    for _, c, t, n, h in tool.TEMPORAL_BWD_SHAPES:
        for seg in (False, True):
            assert bounds.temporal_bwd_work(c, t, n, h, seg) == tool.temporal_bwd_work(c, t, n, h, seg)
    for _, c, t, n, h in tool.TEMPORAL_FWD_SHAPES:
        assert bounds.temporal_fwd_work(c, t, n, h) == tool.temporal_fwd_work(c, t, n, h)
    assert bounds.segment_core_work(4, 64) == tool.segment_core_work(4, 64)


def _gemm_args(m, k, n, kn=False, bias=False, aux=False, out_f32=False, out_bf16=True):
    dims = [[m, k], [k, n] if kn else [n, k], [], [n] if bias else [], [], [m, n] if aux else [],
            [], [], [], [], [], [], [], [], [], []]
    types = ["c10::BFloat16", "c10::BFloat16", "Scalar", "c10::BFloat16" if bias else ""] + [""] * 12
    concrete = ["", "", str(kn), "", "2", "", "0", "1.0", "", "", "1", "", "",
                str(out_f32), str(out_bf16), "False"]
    return {"Input Dims": dims, "Input type": types, "Concrete Inputs": concrete}


def test_gemm_launch_reads_as_the_tool_counts():
    assert trace.op_work("aim_port::gemm", _gemm_args(50432, 768, 2304)) == tool.gemm_work(
        50432, 768, 2304)
    args = _gemm_args(50432, 768, 3072, kn=True, aux=True)
    assert trace.op_work("aim_port::gemm", args) == tool.gemm_work(50432, 768, 3072, 1, 2)
    args = _gemm_args(50432, 768, 192, bias=True, out_f32=True)
    assert trace.op_work("aim_port::gemm", args) == tool.gemm_work(50432, 768, 192, 0, 6, True)


def test_attention_launches_read_as_the_tool_counts():
    qkv = [256 * 197, 3 * 768]
    spatial = {"Input Dims": [qkv, [], [], []], "Concrete Inputs": ["", "256", "197", "False"]}
    assert trace.op_work("aim_port::spatial_attention", spatial) == tool.spatial_core_work(
        256, 12, 197)
    bwd = {"Input Dims": [qkv, [256 * 197, 768], [], [], []],
           "Concrete Inputs": ["", "", "256", "197", "False"]}
    assert trace.op_work("aim_port::spatial_attention_bwd", bwd) == tool.spatial_core_work(
        256, 12, 197, True)
    temporal = {"Input Dims": [qkv, [], [], []], "Concrete Inputs": ["", "32", "8", "197"]}
    assert trace.op_work("aim_port::temporal_attention", temporal) == tool.temporal_fwd_work(
        32, 8, 197, 12)
    assert trace.op_work("aim_port::temporal_attention", {"Input Dims": [qkv]}) is None
