"""Device milliseconds of a force's FFTs: the kernels, copies and fills
launched inside the program's `force.r2c` and `force.c2r` spans (cuFFT
and the Norm scaling), over the forces of the window
(pmbench/spans.py)."""

from pmbench import spans


def read(ctx):
    return spans.per_force_ms(ctx, ["force.r2c", "force.c2r"])
