"""Megabytes (10^6 B) per request that the upload copies to the card: the
program's `upload_bytes` counter (render/base.py `batch_to_device`, after
the rulebooks' widening to int64)."""

from benchmark import spans


def read(ctx):
    c = spans.counters()
    return spans.per_request(ctx.trace, c["upload_bytes"] / 1e6
                             if c and "upload_bytes" in c else None)
