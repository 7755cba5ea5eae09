"""Device milliseconds per request of the kernels launched inside the
forward of the renderer's encoder (`Renderer.encoder`, models/encoder.py)."""

from benchmark.loops import ENCODER


def read(ctx):
    s = ctx.trace.span_device_s(ENCODER)
    return s / ctx.trace.units * 1e3 if s and ctx.trace.units else None
