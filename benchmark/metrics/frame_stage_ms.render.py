"""Device milliseconds per request of the kernels launched inside the
program's frame-stage span, `gpnerf.frame_stage` (render/demo.py
`Renderer._frame_stage`: volume, occupancy, tables, splats, rays)."""

from benchmark import spans


def read(ctx):
    return spans.per_request(ctx.trace, spans.device_ms(ctx.trace, "gpnerf.frame_stage"))
