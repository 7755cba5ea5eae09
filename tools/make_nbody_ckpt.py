"""Seeded weights for Neural Body at its published widths and the latent rows of
benchmark/configs/neuralbody-zju.json: the checkpoint the `neuralbody-zju`
configuration names.

    python3 tools/make_nbody_ckpt.py --seed 2012158380 --out artifacts/nbody_ckpt.pth

Plain torch on the CPU, through the plain reference of the configuration
(benchmark/reference/nbody/: its network, masked dense convs and query) on
a frame of the frozen data layer (benchmark/reference/eager/data/);
nothing of the port. Everything is drawn from `--seed`:

  * each sparse conv weight, the vertex codes and every Linear weight of
    256 or more inputs is a window view of one short seeded draw: entry
    (i_0, ..., i_k) is draw[sum_j i_j * stride_j] times the layer's
    Kaiming scale (sqrt(2 / fan_in) before a ReLU, sqrt(1 / fan_in)
    otherwise; codes unit normal). The checkpoint stores the draws and
    the views' strides, a few hundred KB for 4.3 M parameters, and a load
    fills every parameter whole;
  * the other parameters are drawn whole: biases uniform in +-1 /
    sqrt(fan_in), latent rows unit normal, BatchNorm scales 1 + 0.1 N and
    shifts 0.1 N;
  * each BatchNorm's running statistics are the mean and the unbiased
    variance of its conv's output over the level's active sites, on one
    frame of the frozen scene (benchmark/scene.py, a pool view drawn from
    the seed), conv by conv in order, as one training pass at momentum 1
    sets them, so each level's features are normalised;
  * alpha_fc is scaled, and its bias set, so that empty space (a query of
    zeros) reads sigma EMPTY_SIGMA and the mean opacity of the frame's rays
    that meet the body is OPACITY, on a SIZE x SIZE view.
    Empty space well below 0 keeps the points that the coarse levels reach
    just past the body (a level-4 voxel is 8 cm) clear of the ReLU's kink,
    where the last sample of a ray (spacing 1e10) would turn opaque on a
    rounding.

Prints the parameter count, the file's size and its sha256.
"""

from __future__ import annotations

import argparse
import functools
import hashlib
import json
import math
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import pool  # noqa: E402
from benchmark.reference import build  # noqa: E402
from benchmark.reference import nbody as ref  # noqa: E402
from benchmark.reference.eager.data.base import HumanNVSDataset  # noqa: E402

CONF = os.path.join(ROOT, "benchmark", "configs", "neuralbody-zju.json")
CONV_STRIDES = (97, 31, 11, 3, 1)
LINEAR_STRIDES = (5, 1)
CODE_STRIDES = (3, 1)
SIZE, OPACITY, EMPTY_SIGMA = 128, 0.6, -8.0
# Linear layers whose output feeds a ReLU
RELU_LINEAR = ("fc_0", "fc_1", "fc_2", "view_fc")


def window(gen, shape, strides, std):
    """A `shape` view with `strides` of one seeded normal draw times std."""
    n = 1 + sum((s - 1) * st for s, st in zip(shape, strides))
    return (torch.randn(n, generator=gen) * std).as_strided(shape, strides)


def draw(net, gen):
    """{parameter name: tensor} of every parameter; the window views are
    kept as views."""
    out = {}
    for name, p in net.named_parameters():
        layer = name.rsplit(".", 1)[0]
        fan_in = p.shape[1] if p.dim() == 2 else None
        if name == "c.weight":
            out[name] = window(gen, tuple(p.shape), CODE_STRIDES, 1.0)
        elif p.dim() == 5:
            out[name] = window(gen, tuple(p.shape), CONV_STRIDES,
                               math.sqrt(2.0 / (27 * p.shape[3])))
        elif name == "latent.weight":
            out[name] = torch.randn(p.shape, generator=gen)
        elif p.dim() == 2:
            std = math.sqrt((2.0 if layer in RELU_LINEAR else 1.0) / fan_in)
            out[name] = (window(gen, tuple(p.shape), LINEAR_STRIDES, std) if fan_in >= 256
                         else torch.randn(p.shape, generator=gen) * std)
        elif layer.startswith("xyzc_net") and name.endswith("weight"):
            out[name] = 1.0 + 0.1 * torch.randn(p.shape, generator=gen)
        elif layer.startswith("xyzc_net"):
            out[name] = 0.1 * torch.randn(p.shape, generator=gen)
        else:
            bound = 1.0 / math.sqrt(dict(net.named_parameters())[layer + ".weight"].shape[1])
            out[name] = (torch.rand(p.shape, generator=gen) * 2 - 1) * bound
    return out


def frame(conf, seed, size):
    """A host batch of one pool view of the frozen scene at size x size,
    from the frozen data layer."""
    cfg = json.loads(json.dumps(conf["cfg"]))
    cfg["dataset"]["H"] = cfg["dataset"]["W"] = size
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(seed, 1, pool.img_hw(cfg))
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", cfg)
    return pool.build_batches(ds, seed, [0], pool.VIEW_TAG)[0]


def _fit(bn, active, _module, _args, y):
    """Forward hook of a conv: its BatchNorm's running statistics from the
    conv's output y (1, C, D, H, W) at the active sites."""
    sites = y[0][:, active].double()
    bn.running_mean.copy_(sites.mean(dim=1))
    bn.running_var.copy_(sites.var(dim=1))


@torch.no_grad()
def set_batchnorm_statistics(net, hb):
    """Each BatchNorm's running statistics from its input over the level's
    active sites, conv by conv in order: one pass of the reference's stack,
    each conv's hook setting its BatchNorm before the BatchNorm runs."""
    cpu = torch.device("cpu")
    vol0, mask0 = ref.code_volume(net, hb["coord"], hb["out_sh"], cpu)
    blocks = net.xyzc_net.net
    masks = ref.level_masks(mask0, len(blocks) // 2)
    hooks = []
    for b, block in enumerate(blocks):
        active = masks[(b + 1) // 2][0, 0] > 0
        hooks += [block[k].register_forward_hook(functools.partial(_fit, block[k + 1], active))
                  for k in range(0, len(block), 3)]
    try:
        net.xyzc_net(vol0, mask0)
    finally:
        for h in hooks:
            h.remove()


@torch.no_grad()
def set_alpha(model, hb, voxel_size, n_samples, opacity, empty_sigma):
    """alpha_fc: sigma = k (u - u_empty) + empty_sigma, u the unscaled
    read-out through the reference's `raw`, k such that the mean opacity
    of the rays that meet the body (a nonzero query on some sample) is
    `opacity`."""
    cpu = torch.device("cpu")
    net = model.net
    fr = ref.Frame(hb, cpu)
    vols, _ = ref.volumes(net, hb, cpu)
    w = net.alpha_fc.weight.detach().clone()
    net.alpha_fc.bias.zero_()
    u, meets, z_vals = [], [], []
    for r0 in range(0, fr.n, ref.CHUNK_RAYS):
        z, wpts, dirs = ref.samples(fr, r0, r0 + ref.CHUNK_RAYS, n_samples)
        u.append(ref.raw(net, vols, fr, wpts, dirs, voxel_size)[:, 3].reshape(-1, n_samples))
        feats = ref.query(vols, fr, wpts, voxel_size).reshape(-1, n_samples, sum(
            v.shape[1] for v in vols))
        meets.append((feats != 0).any(dim=-1).any(dim=-1))
        z_vals.append(z)
    u, meets, z = torch.cat(u), torch.cat(meets), torch.cat(z_vals)
    zeros = torch.zeros(1, net.fc_0.in_features)
    u_empty = net(zeros, net.latent.weight[0], torch.zeros(1, 3 * (1 + 2 * net.view_res)),
                  torch.zeros(1, 3 * (1 + 2 * net.xyz_res)))[0, 3].item()
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(fr.ray_d, dim=-1)[:, None]

    def mean_opacity(k):
        sigma = torch.relu(k * (u - u_empty) + empty_sigma)
        return (1.0 - torch.exp(-(sigma * dists).sum(dim=-1)))[meets].mean().item()

    lo, hi = 1e-3, 1e5
    for _ in range(60):
        k = math.sqrt(lo * hi)
        lo, hi = (k, hi) if mean_opacity(k) < opacity else (lo, k)
    k = math.sqrt(lo * hi)
    net.alpha_fc.weight.copy_(k * w)
    net.alpha_fc.bias.fill_(-k * u_empty + empty_sigma)
    return k, mean_opacity(k), int(meets.sum()), fr.n


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    conf = json.load(open(CONF))
    cfg = conf["cfg"]
    nb = ref.widths(cfg)
    model = ref.NeuralBody(nb).eval()
    net = model.net
    gen = torch.Generator().manual_seed(args.seed)
    drawn = draw(net, gen)
    hb = frame(conf, args.seed, SIZE)
    with build.tf32(False), torch.no_grad():
        for name, p_ in net.named_parameters():
            p_.copy_(drawn[name])
        set_batchnorm_statistics(net, hb)
        k, opacity, meets, n = set_alpha(model, hb, tuple(cfg["dataset"]["voxel_size"]),
                                         nb["n_samples"], OPACITY, EMPTY_SIGMA)

    state = {}
    for name, t in net.state_dict().items():
        keep_view = name in drawn and name not in ("alpha_fc.weight", "alpha_fc.bias")
        state["net." + name] = drawn[name] if keep_view and drawn[name].dim() > 1 and \
            not drawn[name].is_contiguous() else t.clone()
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    torch.save(state, args.out)
    with open(args.out, "rb") as f:
        data = f.read()
    params = sum(p_.numel() for p_ in net.parameters())
    print(json.dumps({"file": args.out, "bytes": len(data), "parameters": params,
                      "sha256": hashlib.sha256(data).hexdigest(), "alpha_scale": k,
                      "mean_opacity": opacity, "rays_meeting_body": meets, "rays": n}))


if __name__ == "__main__":
    main()
