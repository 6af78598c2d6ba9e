"""eval_videos_per_s (videos/s): every video scored (all its views) in the
window over the window's time, the last call's wait included."""


def read(ctx):
    if ctx["kind"] != "eval":
        return None
    w = ctx["window"]
    return w["units"] / w["seconds"]
