"""The whole frame's share of the card's bf16 peak: the frozen analytic
FLOPs of each traced request, at the reference's counts (kept slots,
colored points, active sites per level), over the traced window."""

from benchmark import costs, pool


def read(ctx):
    peak = costs.peak(ctx.device_name, "bfloat16")
    if peak is None or not ctx.items:
        return None
    H, W = pool.img_hw(ctx.conf["cfg"])
    flops = sum(costs.frame_flops(H, W, ctx.ref[i]["counts"][1], ctx.ref[i]["counts"][2],
                                  ctx.ref[i]["sites"]) for i in ctx.items)
    return 100.0 * flops / ctx.trace.window_s / peak
