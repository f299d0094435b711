"""Device milliseconds of a force's readout: the kernels, copies and
fills launched inside the program's `force.readout` span (K2 or K4),
over the forces of the window (pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_force_ms(ctx, ["force.readout"])
