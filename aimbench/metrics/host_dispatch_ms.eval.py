"""host_dispatch_ms.eval (ms): the host's time enqueueing a multi-view call
(the entry's Python, the staged copy of the batch, the launches), each call
started on an idle device and timed to its return, before its scores are
read, by the host clock, averaged over the traced run's unprofiled
sub-window."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    return ctx.get("dispatch_ms")
