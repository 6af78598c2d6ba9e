"""idle_share.eval (%): the share of the plain profiled sub-window in which no
kernel, copy or fill ran on the device."""


def read(ctx):
    t = ctx.get("timeline")
    if ctx["kind"] != "eval" or not t:
        return None
    return 100.0 * (t["window_s"] - t["busy_s"]) / t["window_s"]
