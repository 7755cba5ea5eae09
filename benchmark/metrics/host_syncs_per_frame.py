"""Blocking runtime calls per request in the traced window: stream, device
and event synchronisation, and synchronous copies."""


def read(ctx):
    return ctx.trace.syncs / ctx.trace.units if ctx.trace.units else None
