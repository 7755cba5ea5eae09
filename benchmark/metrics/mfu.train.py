"""The whole step's share of the card's float32 peak (TF32 off, as the
configuration trains): the analytic forward and backward FLOPs of each
traced step, at its batch's active sites per level, over the traced
window."""

from benchmark import costs, pool


def read(ctx):
    peak = costs.peak(ctx.device_name, "float32")
    if peak is None or not ctx.trace.units:
        return None
    cfg = ctx.conf["cfg"]
    H, W = pool.img_hw(cfg)
    points = cfg["train"]["n_rays"] * cfg["train"]["n_samples"]
    sites = ctx.sites
    first = ctx.window["first"]
    flops = sum(costs.train_step_flops(H, W, points, sites[(first + k) % len(sites)])
                for k in range(ctx.trace.units))
    return 100.0 * flops / ctx.trace.window_s / peak
