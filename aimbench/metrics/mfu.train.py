"""mfu.train (%): the operations the window's work requires (a clip, aimbench.flops.train_flops)
over the window's time and one H100's dense bf16 peak."""



def read(ctx):
    w = ctx["window"]
    if ctx["kind"] != "train" or ctx["peak_bytes"] <= 0:
        return None
    return 100.0 * w["units"] * ctx["flops_per_unit"] / w["seconds"] / ctx["peak_flops"]
