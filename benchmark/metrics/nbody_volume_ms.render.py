"""Device milliseconds per request of the kernels launched inside the
program's span `nbody.volume` (render/neural_body.py: the vertex codes,
the sparse stack and the dense volumes), where the program opened one
`nbody.render` span in each traced request; else None."""

from benchmark import spans


def read(ctx):
    n = len(spans.intervals(ctx.trace, "nbody.render"))
    ms = spans.device_ms(ctx.trace, "nbody.volume")
    return ms / n if n and n == ctx.trace.units and ms is not None else None
