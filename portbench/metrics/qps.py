"""qps: Queries answered over the whole window's wall time."""

UNIT = "q/s"
BETTER = "higher"


def read(ctx):
    return ctx["queries"] / ctx["window_s"]
