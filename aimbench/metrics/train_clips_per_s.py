"""train_clips_per_s (clips/s): every clip stepped in the window over the
window's time, the last step's wait for the device included."""


def read(ctx):
    if ctx["kind"] != "train":
        return None
    w = ctx["window"]
    return w["units"] / w["seconds"]
