"""Neural Body's whole frame's share of the card's bf16 peak: the analytic
FLOPs of each traced request (benchmark/nbody_costs.py: the sparse stack
at the reference's active sites per level, and the MLP at the reference's
`points`) over the traced window."""

from benchmark import costs, nbody_costs


def read(ctx):
    peak = costs.peak(ctx.device_name, "bfloat16")
    if peak is None or not ctx.items:
        return None
    flops = sum(nbody_costs.volume_flops(ctx.ref[i]["sites"])
                + nbody_costs.point_flops(ctx.ref[i]["points"]) for i in ctx.items)
    return 100.0 * flops / ctx.trace.window_s / peak
