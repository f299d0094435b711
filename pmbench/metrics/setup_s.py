"""Seconds from the start of the process to the opening of the window:
imports, the card's context, the kernels' build where it is not cached,
the entry's set-up and its warm pass."""


def read(ctx):
    return ctx.setup_s
