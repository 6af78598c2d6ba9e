"""peak_mem_gib (GiB): torch.cuda.max_memory_allocated() over set-up and
window; it sets the batch a card holds."""


def read(ctx):
    return ctx["peak_bytes"] / 2 ** 30 if ctx["peak_bytes"] > 0 else None
