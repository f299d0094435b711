"""K4's share of the bandwidth roofline in percent (csrc/cic_readout.cu as
cic_readout3: the multi-species force's readout of each species): the
bytes pmbench/roofline.py counts for the forces of the window, over the
device time of the kernels named readout_kernel that a force launched.
Silent where the cell's force does not take this kernel's path (several
species)."""

from pmbench import roofline

MULTI = True


def read(ctx):
    shapes = ctx.shapes
    if ctx.trace is None or (len(shapes["rows"]) > 1) != MULTI:
        return None
    seconds, launches = ctx.trace.kernel_seconds("readout_kernel",
                                                 "pmbench.force")
    forces = ctx.trace.count("pmbench.force")
    if not launches or not forces:
        return None
    mesh = shapes["mesh"]
    per_force = sum(roofline.k4_bytes(rows, mesh)
                    for name, rows in shapes["rows"].items())
    return roofline.share_pct(forces * per_force, seconds)
