"""The time steps' share of the card's float32 peak in percent: the
operations pmbench/roofline.py counts for the window's force actions,
kicks and drifts over the device time of the program's `force`, `kick`
and `drift` clocks (CUDA events in the traced run). It bounds the
kernels' roofline shares: a kernel taken off the force's path leaves its
own share silent, and this one still moves."""

from pmbench import roofline


def read(ctx):
    rows = list(ctx.shapes["rows"].values())
    mesh = ctx.shapes["mesh"]
    seconds = flops = 0.0
    for name, per in (("force", roofline.force_flops(rows, mesh)),
                      ("kick", roofline.kick_drift_flops(sum(rows))),
                      ("drift", roofline.kick_drift_flops(sum(rows)))):
        s, n = ctx.clocks.get(name, (0.0, 0))
        seconds += s
        flops += n * per
    if seconds <= 0 or not flops:
        return None
    return 100.0 * flops / roofline.PEAK_F32_FLOPS / seconds
