"""Host milliseconds per request inside the program's upload span,
`gpnerf.upload` (render/base.py `batch_to_device`: the request's batch
copied to the card)."""

from benchmark import spans


def read(ctx):
    return spans.per_request(ctx.trace, spans.host_ms(ctx.trace, "gpnerf.upload"))
