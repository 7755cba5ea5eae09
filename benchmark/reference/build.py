"""The plain reference of both configurations, and its control.

The reference is `benchmark/reference/eager/`, a frozen copy of the port's
eager modules at commit ffa1347 with every hand-written kernel, the fused
point-stage path and the program's registries removed: the progressive
renderer op by op and the training renderer's forward, computed in
float32 with TF32 off. It imports nothing of the program; it assembles its
own batches from the benchmark's raw inputs (its copy of the data layer
builds the sparse pyramid, the rulebooks and the rays), and works out the
quantized tables and the cull again.

The control is the reference one precision step below what a
configuration states: for the bfloat16 renderer, fp8 (e4m3, one scale per
tensor) in every weight and in the input of every convolution and Linear
layer; for float32 training, TF32.
"""

from __future__ import annotations

import contextlib
import hashlib
from types import SimpleNamespace

import torch
from torch import nn

from benchmark.reference.eager.models.encoder import build_encoder
from benchmark.reference.eager.models.heads import build_head
from benchmark.reference.eager.render import base as base_render
from benchmark.reference.eager.render import demo as demo_render

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def namespace(tree):
    if isinstance(tree, dict):
        return SimpleNamespace(**{k: namespace(v) for k, v in tree.items()})
    return tree


def check_weights(weights):
    """The weights file's path, once its sha256 is the configuration's
    (a configuration's `weights`: file, sha256)."""
    with open(weights["file"], "rb") as f:
        got = hashlib.sha256(f.read()).hexdigest()
    if got != weights["sha256"]:
        raise SystemExit(f"weights {weights['file']}: sha256 {got} is not the "
                         f"configuration's {weights['sha256']}")
    return weights["file"]


def load_weights(model, weights):
    """The configuration's checkpoint into `model` (strict)."""
    ckpt = torch.load(check_weights(weights), map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    model.load_state_dict(state, strict=True)
    return model


def demo_renderer(cfg_tree, device):
    """The progressive renderer of a configuration, op by op in float32."""
    cfg = namespace(cfg_tree)
    t = cfg.tpu
    r = demo_render.Renderer(
        build_encoder(cfg), build_head(cfg),
        voxel_size=tuple(cfg.dataset.voxel_size), n_samples=cfg.train.n_samples,
        samples_per_ray=t.samples_per_ray, ray_cap=t.ray_cap,
        bin_margin_voxels=t.bin_margin_voxels, max_out_sh=tuple(t.max_out_sh),
        compute_dtype=None, tight_cull=t.tight_cull, splat_cap=t.splat_cap,
        frame_mode=t.frame_mode, sigma_query_cull=t.sigma_query_cull, int4_feat=t.int4_feat,
        kernel_octet=t.kernel_octet, pallas_point=False, pallas_lerp=False,
        proj_vp_order=t.proj_vp_order, merge_src_feat=t.merge_src_feat,
        merge_lowres_src=t.merge_lowres_src, quantize_proj=t.quantize_proj,
        **{k: getattr(t, k) for k in demo_render.GEOMETRY_SWITCHES},
        dense_slots=t.dense_slots, sigma_cap=t.sigma_cap, neg_ray_val=False,
        n_views=cfg.src_view_num, splat_bins=t.splat_bins, tap_window=t.tap_window,
        window_margin_voxels=t.window_margin_voxels,
    )
    return r.to(device).eval()


def train_renderer(cfg_tree, device):
    """The training renderer of a configuration, in float32."""
    cfg = namespace(cfg_tree)
    r = base_render.Renderer(
        build_encoder(cfg), build_head(cfg), voxel_size=tuple(cfg.dataset.voxel_size),
        max_out_sh=tuple(cfg.tpu.max_out_sh), n_samples=cfg.train.n_samples,
        occupancy_cull=cfg.tpu.base_occupancy_cull)
    return r.to(device)


def fp8_round(x):
    """`x` rounded to fp8 e4m3 under one scale (its largest magnitude maps
    to the format's largest value), as float32."""
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((x.float() / scale).to(FP8).float() * scale).to(x.dtype)


def fp8_control(model):
    """The render control: every floating parameter rounded to fp8 in
    place, and the input of each Conv2d and Linear layer rounded on entry.
    Returns the hook handles."""
    with torch.no_grad():
        for p in model.parameters():
            if p.is_floating_point():
                p.copy_(fp8_round(p))

    def pre(_m, args):
        return (fp8_round(args[0]),) + tuple(args[1:])

    return [m.register_forward_pre_hook(pre) for m in model.modules()
            if isinstance(m, (nn.Conv2d, nn.Linear))]


@contextlib.contextmanager
def tf32(on):
    """TF32 in cuBLAS and cuDNN on or off while held."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = bool(on)
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old
