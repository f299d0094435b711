"""Device milliseconds of a force's k-space passes: the kernels, copies
and fills launched inside the program's `force.kspace` span (the
softening, the transfers and each gradient multiply), over the forces of
the window (pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_force_ms(ctx, ["force.kspace"])
