"""setup_s: From the process's start to the window's first request:
imports, the inputs drawn from the seed, the port's set-up, kernel
builds and warm-up."""

UNIT = "s"
BETTER = "lower"


def read(ctx):
    return ctx["setup_s"]
