"""Device milliseconds per request of the kernels launched inside the
program's point-stage span, `gpnerf.point_stages` (render/demo.py
`Renderer._point_stages`: the projection and geometry row gathers and the
point-stage kernel, or the stages op by op)."""

from benchmark import spans


def read(ctx):
    return spans.per_request(ctx.trace, spans.device_ms(ctx.trace, "gpnerf.point_stages"))
