"""setup_s (s): from the start of the process to the window: imports, the
kernel library's load (its build in a checkout's first run), building and
drawing the model and the batches, the first calls."""


def read(ctx):
    return ctx["setup_s"]
