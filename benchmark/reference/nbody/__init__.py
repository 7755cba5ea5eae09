"""Neural Body's plain reference: what decides `correct` in the cells of
the `neuralbody-zju` configuration.

Written from the source (Peng et al., CVPR 2021; zju3dv/neuralbody
lib/networks/latent_xyzc.py, lib/networks/embedder.py,
lib/networks/renderer/if_clight_renderer.py), in float32 with TF32 off,
importing nothing of the program: its batches come from the frozen data
layer (benchmark/reference/eager/data/), of which it reads the SMPL voxel
coordinates, `out_sh`, the SMPL-space bounds, `Rh`, `Th`, the latent index
and the test rays, and nothing of the sparse pyramid.

  * The codes `c` (one per SMPL vertex) are written into a dense level-0
    volume of the frame's `out_sh` at the vertices' voxels.
  * Each sparse conv is a dense 3x3x3 convolution (padding 1) whose output
    is kept at the level's active sites: a submanifold conv keeps its input
    level's sites; a strided conv (stride 2) keeps the sites whose 3^3
    receptive field holds an active input, a 3^3 max-pool of the input
    level's mask, computed here. Each is bias-free and followed by the
    BatchNorm (running statistics, eps 1e-3) and ReLU, and re-masked, so a
    level is zero at its inactive sites, as spconv's `.dense()` is.
  * The query: `F.grid_sample` of each (1, C, D, H, W) level volume with
    `align_corners=True` and zero padding at the points mapped world ->
    SMPL space ((x - Th) Rh) -> voxels -> [-1, 1], the four levels
    concatenated to 352 channels.
  * The MLP as in latent_xyzc.py, its 1x1 Conv1d layers as Linear layers;
    the encodings as embedder.py's (10 frequencies for the world point, 4
    for the unit view direction); the compositing as the renderer's
    raw2outputs with no noise and no white background; 64 samples evenly
    spaced on every test ray of the batch, which are the rays that hit the
    body's box, in world coordinates, as the source's.

Departures from the source:
  * vertices that share a level-0 voxel: the code of the first (the lowest
    vertex index) is taken; spconv does not specify which of duplicate
    indices wins;
  * the latent row is min(latent_index, num_train_frame - 1), as the source
    treats a pose past its training frames;
  * the frame's voxel grid and `out_sh` are the data layer's, clamped to
    its `max_out_sh` (the configuration's `assumed`), where the source's
    grid follows the body.

`control=True` is the control of benchmark/reference/build.py: every
weight and the input of every Linear layer and sparse convolution rounded
to fp8 (e4m3, one scale per tensor).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from benchmark import pool
from benchmark.reference import build
from benchmark.reference.eager.data.base import HumanNVSDataset

BN_EPS = 1e-3
CHUNK_RAYS = 8192
# latent_xyzc.py's widths
PUBLISHED = {"n_smpl": 6890, "code_dim": 16, "out_dim": [32, 64, 128, 128],
             "convs": [2, 2, 3, 3, 3], "width": 256, "view_width": 128, "latent_dim": 128}


def widths(cfg):
    """The network's sizes for a configuration's `cfg`: the published
    widths, and its latent rows (`num_frame`, the source's
    num_train_frame), encoder frequencies and samples a ray."""
    return dict(PUBLISHED, num_train_frame=cfg["num_frame"], xyz_res=cfg["xyz_res"],
                view_res=cfg["view_res"], n_samples=cfg["train"]["n_samples"])


class SpConv(nn.Module):
    """A sparse conv's weight, spconv's (kD, kH, kW, Cin, Cout) layout."""

    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(3, 3, 3, cin, cout))

    def forward(self, x, stride):
        return F.conv3d(x, self.weight.permute(4, 3, 0, 1, 2), stride=stride, padding=1)


class Block(nn.Sequential):
    """`n` convs, each followed by its BatchNorm1d and ReLU (spconv's
    SparseSequential of the source's double_conv, triple_conv and
    stride_conv)."""

    def __init__(self, cin, cout, n):
        mods = []
        for k in range(n):
            mods += [SpConv(cin if k == 0 else cout, cout),
                     nn.BatchNorm1d(cout, eps=BN_EPS, momentum=0.01), nn.ReLU()]
        super().__init__(*mods)

    def run(self, x, mask, stride=1):
        for k in range(0, len(self), 3):
            conv, bn = self[k], self[k + 1]
            x = conv(x, stride if k == 0 else 1)
            x = F.batch_norm(x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
                             training=False, eps=BN_EPS)
            x = F.relu(x) * mask
        return x


def level_masks(mask0, n):
    """The active sites (1, 1, D, H, W) of level 0 and of the n strided
    levels above it: a stride-2 conv's output is active where its 3^3
    receptive field holds an active input."""
    masks = [mask0]
    for _ in range(n):
        masks.append(F.max_pool3d(masks[-1], 3, stride=2, padding=1))
    return masks


class SparseConvNet(nn.Module):
    """conv0, then down_i and conv_{i+1} for i = 0..3; volumes 1-4 taken
    after conv1..conv4. Blocks at `net.{0..8}`."""

    def __init__(self, code_dim, out_dim, convs):
        super().__init__()
        mods = [Block(code_dim, code_dim, convs[0])]
        cin = code_dim
        for i, c in enumerate(out_dim):
            mods += [Block(cin, c, 1), Block(c, c, convs[i + 1])]
            cin = c
        self.net = nn.ModuleList(mods)

    def forward(self, x, mask0):
        """x (1, code_dim, D, H, W) codes, mask0 (1, 1, D, H, W) the active
        level-0 sites; returns the four volumes and the five masks."""
        masks = level_masks(mask0, len(self.net) // 2)
        x = self.net[0].run(x, masks[0])
        vols = []
        for i in range(len(self.net) // 2):
            x = self.net[2 * i + 1].run(x, masks[i + 1], stride=2)
            x = self.net[2 * i + 2].run(x, masks[i + 1])
            vols.append(x)
        return vols, masks


def embed(x, multires):
    """embedder.py's Embedder: include_input, log sampling, max_freq_log2
    multires - 1, num_freqs multires, sin then cos."""
    out = [x]
    for freq in 2.0 ** torch.linspace(0.0, multires - 1, steps=multires):
        out += [torch.sin(x * freq), torch.cos(x * freq)]
    return torch.cat(out, dim=-1)


class Network(nn.Module):
    """latent_xyzc.py's Network."""

    def __init__(self, nb):
        super().__init__()
        width, out_dim = nb["width"], nb["out_dim"]
        self.xyz_res, self.view_res = nb["xyz_res"], nb["view_res"]
        self.c = nn.Embedding(nb["n_smpl"], nb["code_dim"])
        self.xyzc_net = SparseConvNet(nb["code_dim"], out_dim, nb["convs"])
        self.latent = nn.Embedding(nb["num_train_frame"], nb["latent_dim"])
        self.fc_0 = nn.Linear(sum(out_dim), width)
        self.fc_1 = nn.Linear(width, width)
        self.fc_2 = nn.Linear(width, width)
        self.alpha_fc = nn.Linear(width, 1)
        self.feature_fc = nn.Linear(width, width)
        self.latent_fc = nn.Linear(width + nb["latent_dim"], width)
        self.view_fc = nn.Linear(width + 3 * (1 + 2 * nb["view_res"])
                                 + 3 * (1 + 2 * nb["xyz_res"]), nb["view_width"])
        self.rgb_fc = nn.Linear(nb["view_width"], 3)

    def forward(self, features, latent, viewdir, light_pts):
        """features (P, 352) the volumes' query, latent (latent_dim,), the
        encoded view directions and world points (P, 27), (P, 63)."""
        net = F.relu(self.fc_0(features))
        net = F.relu(self.fc_1(net))
        net = F.relu(self.fc_2(net))
        alpha = self.alpha_fc(net)
        features = self.feature_fc(net)
        features = torch.cat([features, latent[None].expand(features.shape[0], -1)], dim=-1)
        features = self.latent_fc(features)
        features = torch.cat([features, viewdir, light_pts], dim=-1)
        net = F.relu(self.view_fc(features))
        return torch.cat([self.rgb_fc(net), alpha], dim=-1)


class NeuralBody(nn.Module):
    """The checkpoint's root: the network under `net`, as the source's
    renderer holds it."""

    def __init__(self, nb):
        super().__init__()
        self.net = Network(nb)


def raw2outputs(raw, z_vals, rays_d):
    """The renderer's raw2outputs, raw_noise_std 0, white_bkgd False."""
    dists = z_vals[..., 1:] - z_vals[..., :-1]
    dists = torch.cat([dists, torch.tensor([1e10]).expand(dists[..., :1].shape).to(dists)], -1)
    dists = dists * torch.norm(rays_d[..., None, :], dim=-1)
    rgb = torch.sigmoid(raw[..., :3])
    alpha = 1.0 - torch.exp(-F.relu(raw[..., 3]) * dists)
    weights = alpha * torch.cumprod(
        torch.cat([torch.ones((alpha.shape[0], 1)).to(alpha), 1.0 - alpha + 1e-10], -1), -1)[:, :-1]
    return torch.sum(weights[..., None] * rgb, -2)


def code_volume(net, coord, out_sh, device):
    """(1, code_dim, D, H, W) codes and (1, 1, D, H, W) mask at the
    vertices' voxels, the lowest vertex index winning a shared voxel."""
    D, H, W = (int(v) for v in out_sh)
    coord = torch.as_tensor(np.asarray(coord), dtype=torch.long, device=device)
    flat = (coord[:, 0] * H + coord[:, 1]) * W + coord[:, 2]
    vid = torch.arange(coord.shape[0], device=device)
    first = torch.full((D * H * W,), coord.shape[0], dtype=torch.long, device=device)
    first = first.scatter_reduce(0, flat, vid, reduce="amin")
    hit = first < coord.shape[0]
    code = net.c.weight
    vol = torch.zeros(D * H * W, code.shape[1], device=device)
    vol[hit] = code[first[hit]]
    vol = vol.T.reshape(1, -1, D, H, W)
    return vol, hit.float().reshape(1, 1, D, H, W)


class Frame:
    """What a render reads of a host batch, as float32 tensors on
    `device`: the test rays (the first `n`), Rh, Th, the SMPL-space bounds'
    minimum, out_sh and the latent index."""

    def __init__(self, hb, device):
        def t(k):
            return torch.as_tensor(np.asarray(hb[k]), device=device)

        self.n = int(hb["n_rays"])
        self.ray_o, self.ray_d = t("ray_o")[:self.n], t("ray_d")[:self.n]
        self.near, self.far = t("near")[:self.n], t("far")[:self.n]
        self.R, self.Th, self.min_xyz = t("Rh"), t("Th").reshape(1, 3), t("bounds")[0]
        self.out_sh = np.asarray(hb["out_sh"])
        self.latent_index = int(hb["latent_index"])


def volumes(net, hb, device):
    """(the four level volumes (1, C, D, H, W), the five masks) of a host
    batch."""
    vol0, mask0 = code_volume(net, hb["coord"], hb["out_sh"], device)
    return net.xyzc_net(vol0, mask0)


def query(vols, frame, wpts, voxel_size):
    """(P, 352) the four volumes read at the world points wpts (P, 3)."""
    pts = torch.matmul(wpts - frame.Th, frame.R)
    dhw = (pts[..., [2, 1, 0]] - frame.min_xyz[[2, 1, 0]]) / torch.tensor(
        voxel_size, dtype=torch.float32, device=wpts.device)
    sh = torch.as_tensor(frame.out_sh, dtype=torch.float32, device=wpts.device)
    grid = (dhw / sh * 2 - 1)[..., [2, 1, 0]]
    return torch.cat([
        F.grid_sample(v, grid[None, None, None], padding_mode="zeros",
                      align_corners=True)[0, :, 0, 0].T for v in vols], dim=-1)


def raw(net, vols, frame, wpts, dirs, voxel_size):
    """(P, 4) rgb and sigma at the world points wpts (P, 3) seen along the
    directions dirs (P, 3)."""
    light_pts = embed(wpts, net.xyz_res)
    viewdir = embed(dirs / torch.norm(dirs, dim=-1, keepdim=True), net.view_res)
    latent = net.latent.weight[min(frame.latent_index, net.latent.num_embeddings - 1)]
    return net(query(vols, frame, wpts, voxel_size), latent, viewdir, light_pts)


def samples(frame, r0, r1, n_samples):
    """(z_vals (R, S), world points (R * S, 3), their directions (R * S,
    3)) of the test rays r0:r1, evenly spaced from near to far."""
    o, d = frame.ray_o[r0:r1], frame.ray_d[r0:r1]
    t_vals = torch.linspace(0.0, 1.0, steps=n_samples, device=o.device)
    z_vals = frame.near[r0:r1, None] * (1.0 - t_vals) + frame.far[r0:r1, None] * t_vals
    wpts = (o[:, None] + d[:, None] * z_vals[..., None]).reshape(-1, 3)
    return z_vals, wpts, d[:, None].repeat(1, n_samples, 1).reshape(-1, 3)


@torch.no_grad()
def render_batch(model, hb, nb, voxel_size, device):
    """The reference's render of one host batch: {"image" (H, W, 3),
    "points" (box rays x samples), "sites" (active sites, levels 0-4),
    "out_sh"}."""
    net, S = model.net, nb["n_samples"]
    vols, masks = volumes(net, hb, device)
    fr = Frame(hb, device)
    rgb_maps = []
    for r0 in range(0, fr.n, CHUNK_RAYS):
        z_vals, wpts, dirs = samples(fr, r0, r0 + CHUNK_RAYS, S)
        rgb_maps.append(raw2outputs(raw(net, vols, fr, wpts, dirs, voxel_size).reshape(-1, S, 4),
                                    z_vals, fr.ray_d[r0:r0 + CHUNK_RAYS]))
    H, W = np.asarray(hb["tar_img"]).shape[:2]
    image = torch.zeros(H * W, 3, device=device)
    mask = torch.as_tensor(np.asarray(hb["mask_at_box"]).reshape(-1), device=device)
    image[mask.nonzero()[:fr.n, 0]] = torch.cat(rgb_maps)
    return {"image": image.reshape(H, W, 3).cpu().numpy(), "points": fr.n * S,
            "sites": [int(m.sum()) for m in masks], "out_sh": [int(v) for v in fr.out_sh]}


def fp8_control(model):
    """build.fp8_control, with the input of each sparse convolution
    rounded too."""
    hooks = build.fp8_control(model)

    def pre(_m, args):
        return (build.fp8_round(args[0]),) + tuple(args[1:])

    return hooks + [m.register_forward_pre_hook(pre) for m in model.modules()
                    if isinstance(m, SpConv)]


def load_model(conf, device, control=False):
    model = build.load_weights(NeuralBody(widths(conf["cfg"])), conf["weights"]).to(device).eval()
    if control:
        fp8_control(model)
    return model


def render_items(conf, scene, poses, cams, seed, items, device, control=False):
    """{item: render_batch} of the reference (or its control) on the
    requests `items` of the pool (poses, cams)."""
    cfg = conf["cfg"]
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", cfg)
    model = load_model(conf, device, control)
    out = {}
    with build.tf32(False), torch.no_grad():
        for i in items:
            hb = pool.build_batches(ds, seed, [i], pool.VIEW_TAG)[0]
            out[i] = render_batch(model, hb, widths(cfg), cfg["dataset"]["voxel_size"], device)
    del model
    return out


def train_readings(conf, scene, poses, cams, seed, t_rands, device, control=False):
    raise NotImplementedError("Neural Body's configuration runs no train cell: its program "
                              "names the views loop only")


def train_sites(conf, scene, poses, cams, seed, n):
    raise NotImplementedError("Neural Body's configuration runs no train cell: its program "
                              "names the views loop only")
