"""Device milliseconds per request of the kernels launched inside the
program's span `nbody.points` (render/neural_body.py: the samples' query
of the volumes, their encodings and the MLP), where the program opened one
`nbody.render` span in each traced request; else None."""

from benchmark import spans


def read(ctx):
    n = len(spans.intervals(ctx.trace, "nbody.render"))
    ms = spans.device_ms(ctx.trace, "nbody.points")
    return ms / n if n and n == ctx.trace.units and ms is not None else None
