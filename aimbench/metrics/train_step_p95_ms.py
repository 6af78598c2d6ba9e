"""train_step_p95_ms (ms): the 95th percentile (statistics.quantiles, n=20)
of every step of the window, each the gap between consecutive step-end
CUDA events (the first from an event recorded as the window opened)."""

from statistics import quantiles


def read(ctx):
    gaps = ctx["window"]["call_ms"]
    if ctx["kind"] != "train" or len(gaps) < 20:
        return None
    return quantiles(gaps, n=20)[18]
