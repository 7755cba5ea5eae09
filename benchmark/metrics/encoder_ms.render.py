"""Device milliseconds per request of the kernels launched inside the
program's encoder span, `gpnerf.encoder` (render/demo.py
`Renderer._encode`: the source images' normalisation and the ResUNet
encoder, models/encoder.py)."""

from benchmark import spans


def read(ctx):
    return spans.per_request(ctx.trace, spans.device_ms(ctx.trace, "gpnerf.encoder"))
