"""Rows of every species times force actions, over the whole window in
seconds: the entry's `particle_steps` counted over every pass of the
window."""


def read(ctx):
    n = ctx.counts.get("particle_steps")
    return n / ctx.window_s if n and ctx.window_s > 0 else None
