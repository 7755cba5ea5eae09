"""The share of the point network's samples that its hand-written kernel
ran: the program's `nbody_kernel_points` counter (the points of each launch
of ops/nbody_points.py's kernel) over its `nbody_points` (each request's
samples), where the program opened one `nbody.render` span in each traced
request; else None. A program that runs the layer as torch ops keeps no
such counter and reads None."""

from benchmark import spans


def read(ctx):
    c = spans.counters()
    n = len(spans.intervals(ctx.trace, "nbody.render"))
    if not n or n != ctx.trace.units or not c or not c.get("nbody_points"):
        return None
    if "nbody_kernel_points" not in c:
        return None
    return 100.0 * c["nbody_kernel_points"] / c["nbody_points"]
