"""Device milliseconds of a force action: the program's `force` clock
(fastpm_torch.prof, CUDA events in the traced run) over its count."""


def read(ctx):
    seconds, count = ctx.clocks.get("force", (0.0, 0))
    return 1e3 * seconds / count if count else None
