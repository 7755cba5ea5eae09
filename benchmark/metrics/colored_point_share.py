"""The share of the points the point stages evaluate that come out colored:
the program's `colored_points` counter (each render's `counts[2]`, points
with alpha above 1e-14) over its `point_slots` (each render's P)."""

from benchmark import spans


def read(ctx):
    c = spans.counters()
    if not spans.requests(ctx.trace) or not c.get("point_slots") or "colored_points" not in c:
        return None
    return 100.0 * c["colored_points"] / c["point_slots"]
