"""Device milliseconds of a force's paint: the kernels, copies and fills
launched inside the program's `force.paint` span (K1 or K3, the mass sum
and the division by the mean mass), over the forces of the window
(pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_force_ms(ctx, ["force.paint"])
