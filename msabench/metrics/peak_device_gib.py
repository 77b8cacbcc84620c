"""peak_device_gib (GiB): torch.cuda.max_memory_allocated over the window,
the fullest the card's allocator got."""


def read(ctx):
    return ctx.peak_bytes / 2**30 if ctx.peak_bytes else None
