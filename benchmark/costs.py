"""The yardstick's arithmetic: the card's published peaks, the analytic
FLOPs of a frame and of a train step, and the point-stage kernel's bytes
and FLOPs.

Frozen copies, at commit ffa1347:
  * `PEAKS` from gpnerf_tpu_torch/utils/roofline.py `HBM_BYTES_PER_S` and
    `PEAK_FLOP_PER_S` (NVIDIA's data sheet, H100 SXM at 700 W, dense);
  * `frame_flops` from bench_torch.py `analytic_flops_per_frame`, with the
    active sites per sparse level taken as an argument where the original
    holds typical counts;
  * `point_stage_cost` from gpnerf_tpu_torch/ops/point_stages.py `cost` and
    `op_counts`, evaluated once per form on the shipped tables (853 B per
    point for form (a), 901 B for form (c), 68,636 B of weights and scales,
    108,748 FLOPs per point: 53,376 multiply-adds and the lerps).
`train_step_flops` counts a train step's forward with the same layers at
the train shapes, and its backward as twice the forward.
"""

from __future__ import annotations

H100 = "NVIDIA H100 80GB HBM3"
PEAKS = {
    H100: {"hbm_bytes_per_s": 3.35e12, "bfloat16": 989e12, "float32": 67e12},
}

POINT_STAGE_BYTES = {"a": 853, "c": 901}
POINT_STAGE_FIXED_BYTES = 68636
POINT_STAGE_FLOPS = 108748


def peak(device_name, key):
    """A published peak of the card, or None for a card the table lacks."""
    return PEAKS.get(device_name, {}).get(key)


def point_stage_cost(form, points):
    """(bytes, FLOPs) of one point-stage call over `points` points."""
    return (POINT_STAGE_BYTES[form] * points + POINT_STAGE_FIXED_BYTES,
            POINT_STAGE_FLOPS * points)


def encoder_flops(H, W, feat_ch=32, views=3):
    """ResNet34-UNet on `views` source views of H x W (multiply-adds x 2)."""
    f = 0.0
    h, w = H // 2, W // 2
    f += 2 * 7 * 7 * 3 * 64 * h * w  # stem
    cin = 64
    for planes, blocks in ((64, 3), (128, 4), (256, 6)):
        h, w = h // 2, w // 2
        for b in range(blocks):
            ci = cin if b == 0 else planes
            f += 2 * 9 * ci * planes * h * w * 2  # conv1 + conv2
            if b == 0:
                f += 2 * ci * planes * h * w  # 1x1 downsample
        cin = planes
    h8, w8 = H // 8, W // 8
    h4, w4 = H // 4, W // 4
    f += 2 * 9 * 256 * 128 * h8 * w8 + 2 * 9 * (128 + 128) * 128 * h8 * w8
    f += 2 * 9 * 128 * 64 * h4 * w4 + 2 * 9 * (64 + 64) * feat_ch * h4 * w4
    f += 2 * feat_ch * feat_ch * h4 * w4
    return f * views


def volume_flops(sites, n_smpl=6890, code_dim=32, feat_ch=32, views=3):
    """Vertex-code fusion and the sparse conv stack; `sites` the active
    sites of levels 0-4."""
    f = 2 * n_smpl * (code_dim * code_dim + 2 * views * feat_ch * code_dim
                      + 2 * views * code_dim + code_dim * code_dim)
    f += 2 * (2 * 27 * code_dim * code_dim * sites[0])
    cin = code_dim
    for lvl in range(4):
        f += 2 * 27 * cin * 32 * sites[lvl + 1]  # strided
        f += 2 * 27 * 32 * 32 * sites[lvl + 1] * 2  # double conv
        cin = 32
    return f


def point_flops(n_sigma, n_rgb):
    """Per-point query, density and color MLPs."""
    f = n_sigma * (2 * 4 * 8 * 32 + 2 * 128 * 64)
    f += n_sigma * 2 * (134 * 64 + 64 * 32 + 32 * 16 + 16)
    f += n_rgb * 2 * (3 * (105 * 64 + 64 * 32 + 2 * 32 * 32) + 96 * 32 + 32 * 16 + 16 * 3)
    return f


def frame_flops(H, W, n_sigma, n_rgb, sites):
    """One progressive frame: encoder, volume, and the point MLPs at the
    frame's kept slots and colored points (gathers and compaction are
    bytes, not FLOPs)."""
    return encoder_flops(H, W) + volume_flops(sites) + point_flops(n_sigma, n_rgb)


def train_step_flops(H, W, n_points, sites):
    """One train step: the forward over every sample of the batch's rays,
    and a backward of twice the forward."""
    return 3 * (encoder_flops(H, W) + volume_flops(sites) + point_flops(n_points, n_points))
