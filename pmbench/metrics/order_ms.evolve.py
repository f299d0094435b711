"""Device milliseconds of a force's cell order: the kernels, copies and
fills launched inside the program's `force.order` span (the carry's cell
sort and its gathers, or the multi-species force's cell orders), over
the forces of the window (pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_force_ms(ctx, ["force.order"])
