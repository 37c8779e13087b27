"""device_mem_gib: ``torch.cuda.max_memory_allocated()`` over set-up and
window."""

UNIT = "GiB"
BETTER = "lower"


def read(ctx):
    return ctx["mem_peak_bytes"] / 2**30
