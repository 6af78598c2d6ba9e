"""host_dispatch_ms.train (ms): the host's time enqueueing a step (the
entry's Python, the staged copy of the pageable host batch, the launches),
each step started on an idle device and timed to its return by the host
clock, averaged over the traced run's unprofiled sub-window."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    return ctx.get("dispatch_ms")
