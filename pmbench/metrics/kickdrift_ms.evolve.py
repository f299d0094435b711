"""Device milliseconds of the kicks and drifts of a time step: the
program's `kick` and `drift` clocks (fastpm_torch.prof, CUDA events in
the traced run) over the steps of the window."""


def read(ctx):
    kick, nk = ctx.clocks.get("kick", (0.0, 0))
    drift, nd = ctx.clocks.get("drift", (0.0, 0))
    steps = ctx.passes * ctx.shapes["steps"]
    return 1e3 * (kick + drift) / steps if steps and nk + nd else None
