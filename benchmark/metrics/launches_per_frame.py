"""CUDA kernel launches per request in the traced window."""


def read(ctx):
    return ctx.trace.launches / ctx.trace.units if ctx.trace.units else None
