"""Milliseconds per request in which the device ran nothing while the host
was inside the program's render span, `gpnerf.render` (render/demo.py
`Renderer.render_demo`: encoder, frame stage, ray pipeline, image)."""

from benchmark import spans


def read(ctx):
    return spans.per_request(ctx.trace, spans.idle_ms(ctx.trace, "gpnerf.render"))
