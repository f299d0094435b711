"""The card's peak of allocated memory over the window in GB (1e9 bytes):
torch.cuda.max_memory_allocated, reset when the window opens."""


def read(ctx):
    return ctx.peak_bytes / 1e9
