"""Device milliseconds per request of the ray pipeline: the kernels
launched inside `gpnerf.ray_pipeline` (render/demo.py
`Renderer._ray_pipeline`: the cull, the slot compactions, the points and
the composite) but not inside its `gpnerf.point_stages`, plus those inside
`gpnerf.assemble` (`Renderer._assemble`: the image scatter)."""

from benchmark import spans


def read(ctx):
    rays = spans.device_ms(ctx.trace, "gpnerf.ray_pipeline")
    image = spans.device_ms(ctx.trace, "gpnerf.assemble")
    return spans.per_request(ctx.trace, None if rays is None or image is None
                             else rays + image)
