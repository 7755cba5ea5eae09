"""The share of the point stages' slots whose rows the point-stage kernel
fetched from the tables itself: the program's `kernel_fetched_slots`
counter (P for each launch of the kernel's tables entry) over its
`point_slots` (each render's P). A program whose kernel reads rows gathered
before it keeps no such counter and reads None."""

from benchmark import spans


def read(ctx):
    c = spans.counters()
    if not spans.requests(ctx.trace) or not c.get("point_slots") or "kernel_fetched_slots" not in c:
        return None
    return 100.0 * c["kernel_fetched_slots"] / c["point_slots"]
