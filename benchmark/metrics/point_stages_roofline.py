"""The point-stage kernel's share of its roofline: the least time the card
could take for the traced requests (the larger of bytes over the HBM peak
and FLOPs over the bf16 peak, from the frozen per-point cost at the slots
the reference's cull keeps) over the kernel's device time."""

from benchmark import costs

KERNEL = "point_stages"


def read(ctx):
    t = ctx.trace.kernel_time_s(KERNEL)
    peak_b = costs.peak(ctx.device_name, "hbm_bytes_per_s")
    peak_f = costs.peak(ctx.device_name, "bfloat16")
    if not t or peak_b is None:
        return None
    form = ctx.conf["point_stage_form"]
    bound = 0.0
    for i in ctx.items:
        b, f = costs.point_stage_cost(form, ctx.ref[i]["counts"][1])
        bound += max(b / peak_b, f / peak_f)
    return 100.0 * bound / t
