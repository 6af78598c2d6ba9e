"""gemm_roofline.eval (%): over the profiled aim_port::gemm launches, the sum
of their least times (aimbench/bounds.py, from each launch's recorded shapes)
over the sum of their kernels' device time."""


def read(ctx):
    fam = (ctx.get("rooflines") or {}).get("gemm")
    if ctx["kind"] != "eval" or not fam:
        return None
    return 100.0 * fam["bound_s"] / fam["device_s"]
