"""The point network's share of its roofline: the least time the card
could take for the traced requests' samples (for each request the larger
of its FLOPs over the bf16 peak and its bytes over the HBM peak,
benchmark/nbody_costs.py, at the reference's `points` and `out_sh`) over
the device time of the kernels launched inside the program's
`nbody.points` spans. The work is counted the same whatever implements the
layer."""

from benchmark import costs, nbody_costs, spans


def read(ctx):
    ms = spans.device_ms(ctx.trace, "nbody.points")
    peak_b = costs.peak(ctx.device_name, "hbm_bytes_per_s")
    peak_f = costs.peak(ctx.device_name, "bfloat16")
    if not ms or peak_b is None or not ctx.items:
        return None
    bound = 0.0
    for i in ctx.items:
        r = ctx.ref[i]
        bound += max(nbody_costs.point_bytes(r["points"], r["out_sh"]) / peak_b,
                     nbody_costs.point_flops(r["points"]) / peak_f)
    return 100.0 * bound / (ms / 1e3)
