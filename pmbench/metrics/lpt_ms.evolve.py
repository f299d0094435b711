"""Device milliseconds of a pass's set-up: the kernels, copies and fills
launched inside the program's `init` (the Solver's meshes and lattice)
and `lpt` (2LPT) spans, over the passes of the window
(pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_pass_ms(ctx, ["init", "lpt"])
