"""Neural Body's point network (render/neural_body.py `_points`): every
sample of a request through the front end (the sample, world -> SMPL ->
level-0 voxels, the unit view direction), the query of the four volumes,
the encodings and the eight layers of the MLP (models/neural_body.py), to
raw (n, S, 4) float32, rgb then sigma.

  nbody_points(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel_size,
               chunk_rays=16384) -> raw

`vols` are `NeuralBody.volumes`' four (C, D, H, W) views of channels-last
storage; `frame` holds the frame's `Th`, `Rh`, `bounds` and `out_sh` (the
uploaded batch does); `latent` is `NeuralBody.latent_row`'s (1, 128).

On CPU tensors the wrapper runs its plain version, `nbody_points_plain`:
the torch path (`NeuralBody.query`'s `F.grid_sample`, `encodings`, `head`)
over chunks of `chunk_rays` rays, sample-major inside a chunk. On CUDA
tensors it launches csrc/nbody_points.cu once for the whole request, built
at first use (ops/cuda_build.py), or raises: `check` names what the kernel
does not take (the published widths in bf16 only; float32 volumes with
their channels innermost and contiguous; float32 rays, depths and frame
tensors). The kernel's sums run in another order than cuBLAS's, so its
bf16 activations differ from the plain version's by rounding flips.
`LAUNCHES` counts the kernel's launches, and each adds its points to the
counter `nbody_kernel_points` (utils/profiling.py).

The kernel reads the weights as `packed_weights` lays them out, cached on
the module until a parameter changes: the six products' weights in bf16,
in chunks of 32 K-columns (fc_0 and view_fc padded to K = 352), each chunk
N/8 x 4 core matrices of 8 x 8; the biases, alpha_fc's and rgb_fc's
weights rounded to bf16 (alpha_fc's and rgb_fc's biases float32, as
`NeuralBody._linear_out` adds them); and latent_fc's latent half, which the
kernel folds into latent_fc's bias once per frame.
"""

from __future__ import annotations

import collections
import ctypes
import weakref

import torch

from gpnerf_tpu_torch.ops import cuda_build
from gpnerf_tpu_torch.ops.rays import sample_points
from gpnerf_tpu_torch.render.base import points_to_dhw_vox
from gpnerf_tpu_torch.utils import roofline
from gpnerf_tpu_torch.utils.profiling import count

LAUNCHES = collections.Counter()
BUILD_LOG = {}
_BUILD = ("nbody_points.cu", "nbody_points")
_lib = None

# the widths the kernel is built for (models/neural_body.py's defaults)
OUT_DIM = (32, 64, 128, 128)
SHAPES = {"fc_0": (256, 352), "fc_1": (256, 256), "fc_2": (256, 256), "alpha_fc": (1, 256),
          "feature_fc": (256, 256), "latent_fc": (256, 384), "view_fc": (128, 346),
          "rgb_fc": (3, 128)}
XYZ_RES, VIEW_RES = 10, 4
K_PAD = 352
CHUNK_K = 32
SMALL = 2056  # floats: biases, alpha_fc's and rgb_fc's weights and biases
POINT_FLOPS = 859904  # benchmark/nbody_costs.py: 2 x 429,952 multiply-adds a sample


def nbody_points_plain(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel_size,
                       chunk_rays=16384):
    """The point network in torch ops: raw (n, S, 4) float32."""
    n, S = z_vals.shape
    raw = rays_o.new_empty(n, S, 4)
    for r0 in range(0, n, chunk_rays):
        r1 = min(n, r0 + chunk_rays)
        o, d = rays_o[r0:r1], rays_d[r0:r1]
        # sample-major: neighbouring points are neighbouring rays' samples
        # at one depth, close in the volumes
        pts = sample_points(o, d, z_vals[r0:r1]).transpose(0, 1).reshape(-1, 3)
        feat = net.query(vols, points_to_dhw_vox(pts, frame, voxel_size), frame["out_sh"])
        view_enc, xyz_enc = net.encodings(pts, d / torch.linalg.norm(d, dim=-1, keepdim=True))
        view_enc = view_enc[None].expand(S, -1, -1).reshape(pts.shape[0], -1)
        out = net.head(feat, latent, view_enc, xyz_enc)
        raw[r0:r1] = out.reshape(S, r1 - r0, 4).transpose(0, 1)
    return raw


def cost(vols, n, S):
    """(bytes, FLOPs) of one call (utils/roofline.py): the volumes at the
    frame's level sizes read once, the rays, depths and `raw` once; the
    MLP's multiply-adds at the published widths, twice."""
    P = n * S
    vol_bytes = sum(v.numel() * v.element_size() for v in vols)
    return vol_bytes + n * 24 + P * 4 + P * 16, POINT_FLOPS * P


def _bf16(t):
    return t.detach().to(torch.bfloat16)


def pack_chunks(w, k_pad=None):
    """(N, K) weights as the kernel's B operand: bf16, K zero-padded to
    `k_pad`, chunks of 32 K-columns, each (N/8, 4) core matrices of 8 rows
    x 8 K-columns, 128 contiguous bytes each; flat."""
    N, K = w.shape
    k_pad = k_pad or K
    wp = torch.zeros(N, k_pad, dtype=torch.bfloat16, device=w.device)
    wp[:, :K] = _bf16(w)
    return wp.reshape(N // 8, 8, k_pad // CHUNK_K, CHUNK_K // 8, 8).permute(2, 0, 3, 1, 4).reshape(-1)


_PACKED = weakref.WeakKeyDictionary()


def _layers(net):
    return [getattr(net, name) for name in SHAPES]


def packed_weights(net):
    """{"wpack": bf16 chunks, "small": float32 (SMALL,), "w_lat": bf16 (256,
    128)} of `net`'s MLP, cached until a parameter changes (in place or
    replaced)."""
    params = [p for layer in _layers(net) for p in (layer.weight, layer.bias)]
    key = tuple((p.data_ptr(), p._version) for p in params)
    hit = _PACKED.get(net)
    if hit is not None and hit[0] == key:
        return hit[1]
    with torch.no_grad():
        lat_w = net.latent_fc.weight
        width = net.fc_1.weight.shape[0]
        wpack = torch.cat([
            pack_chunks(net.fc_0.weight, K_PAD), pack_chunks(net.fc_1.weight),
            pack_chunks(net.fc_2.weight), pack_chunks(net.feature_fc.weight),
            pack_chunks(lat_w[:, :width]), pack_chunks(net.view_fc.weight, K_PAD)])
        hidden = (net.fc_0, net.fc_1, net.fc_2, net.feature_fc, net.latent_fc, net.view_fc)
        small = torch.cat([
            *(_bf16(layer.bias).float() for layer in hidden),
            _bf16(net.alpha_fc.weight).float().reshape(-1),
            _bf16(net.rgb_fc.weight).float().reshape(-1),
            net.alpha_fc.bias.detach().float(), net.rgb_fc.bias.detach().float()])
        small = torch.cat([small, small.new_zeros(SMALL - small.numel())])
        packed = {"wpack": wpack, "small": small,
                  "w_lat": _bf16(lat_w[:, width:]).contiguous()}
    _PACKED[net] = (key, packed)
    return packed


def _level_shapes(out_sh):
    return [tuple(int(v) >> (i + 1) for v in out_sh) for i in range(len(OUT_DIM))]


def check(net, vols, frame, rays_o, rays_d, z_vals, latent):
    """Raise (NotImplementedError or ValueError, naming the reason) on what
    the kernel does not take; return its host geometry: out_sh, then each
    level's D, H, W and D and H strides (elements)."""
    what = "nbody_points"
    shapes = {name: tuple(getattr(net, name).weight.shape) for name in SHAPES}
    if (shapes != SHAPES or (net.xyz_res, net.view_res) != (XYZ_RES, VIEW_RES)
            or net.latent.embedding_dim != SHAPES["latent_fc"][1] - SHAPES["latent_fc"][0]):
        raise NotImplementedError(
            f"{what}: the kernel is built for the published widths {SHAPES} with xyz_res "
            f"{XYZ_RES} and view_res {VIEW_RES}; got {shapes}, xyz_res {net.xyz_res}, "
            f"view_res {net.view_res}")
    if net.compute_dtype != torch.bfloat16:
        raise NotImplementedError(
            f"{what}: the kernel computes in bfloat16; the network's compute dtype is "
            f"{net.compute_dtype}")
    dev = rays_o.device
    n, S = z_vals.shape
    named = [("rays_o", rays_o, (n, 3)), ("rays_d", rays_d, (n, 3)), ("z_vals", z_vals, (n, S)),
             ("latent", latent, (1, SHAPES["latent_fc"][1] - SHAPES["latent_fc"][0])),
             ("Th", frame["Th"], None), ("Rh", frame["Rh"], (3, 3)),
             ("bounds", frame["bounds"], (2, 3))]
    for name, t, shape in named:
        if t.dtype != torch.float32:
            raise NotImplementedError(f"{what}: {name} must be float32, not {t.dtype}")
        if (shape is not None and tuple(t.shape) != shape) or (shape is None and t.numel() != 3):
            raise ValueError(f"{what}: {name} has shape {tuple(t.shape)}, expected {shape or 3}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous and on the rays' device")
    if n * S >= 2**31:
        raise NotImplementedError(f"{what}: {n * S} points exceed the kernel's int32 counts")
    if len(vols) != len(OUT_DIM):
        raise ValueError(f"{what}: {len(vols)} volumes, expected {len(OUT_DIM)}")
    geom = [int(v) for v in frame["out_sh"]]
    for i, (v, c, dhw) in enumerate(zip(vols, OUT_DIM, _level_shapes(frame["out_sh"]))):
        if v.dtype != torch.float32:
            raise NotImplementedError(f"{what}: volume {i} must be float32, not {v.dtype}")
        if v.dim() != 4 or tuple(v.shape) != (c, *dhw):
            raise ValueError(f"{what}: volume {i} has shape {tuple(v.shape)}, expected "
                             f"{(c, *dhw)} (channels, the frame's level size)")
        sc, sd, sh, sw = v.stride()
        if sc != 1 or sw != c or sh < c * dhw[2] or sd < sh * dhw[1]:
            raise ValueError(
                f"{what}: volume {i} has strides {v.stride()}: the kernel reads channels-last "
                "volumes, each voxel's channels contiguous (channel stride 1, W stride C)")
        if v.device != dev or v.data_ptr() % 16:
            raise ValueError(f"{what}: volume {i} must be 16-byte aligned and on the rays' device")
        if sd * dhw[0] >= 2**31:
            raise NotImplementedError(f"{what}: volume {i} exceeds the kernel's int32 offsets")
        geom += [*dhw, sd, sh]
    return geom


def start_build():
    """Start nvcc for csrc/nbody_points.cu unless its library exists;
    returns the Popen (or None) to hand to load_library."""
    return cuda_build.start_build(*_BUILD)


def load_library(proc=None):
    """Build (unless the hashed library exists) and load the kernel."""
    global _lib
    if _lib is None:
        lib = cuda_build.load(*_BUILD, proc=proc, build_log=BUILD_LOG, log_key="nbody_points")
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.nbody_points_launch.argtypes = [vp] * 11 + [cf] * 3 + [vp] * 4 + [ci] * 2 + [vp] * 2
        for fn in (lib.nbody_points_launch, lib.nbody_points_smem_bytes):
            fn.restype = ci
        _lib = lib
    return _lib


def _raise_on(err, what):
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def nbody_points(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel_size,
                 chunk_rays=16384):
    """raw (n, S, 4) float32 of the n rays' S samples at depths `z_vals`
    (n, S): the plain version on CPU tensors, the kernel on CUDA tensors."""
    n, S = z_vals.shape
    with roofline.note_kernel("nbody_points", *cost(vols, n, S)):
        dev = rays_o.device
        if dev.type == "cpu":
            return nbody_points_plain(net, vols, frame, rays_o, rays_d, z_vals, latent,
                                      voxel_size, chunk_rays)
        if dev.type != "cuda":
            raise ValueError(f"nbody_points: unsupported device {dev}")
        return _launch(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel_size)


def _launch(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel_size):
    geom = check(net, vols, frame, rays_o, rays_d, z_vals, latent)
    n, S = z_vals.shape
    raw = torch.empty(n, S, 4, dtype=torch.float32, device=rays_o.device)
    if n * S == 0:
        return raw
    w = packed_weights(net)
    lib = load_library()
    vs_w, vs_h, vs_d = (float(v) for v in voxel_size)
    _raise_on(lib.nbody_points_launch(
        rays_o.data_ptr(), rays_d.data_ptr(), z_vals.data_ptr(), frame["Th"].data_ptr(),
        frame["Rh"].data_ptr(), frame["bounds"].data_ptr(), *(v.data_ptr() for v in vols),
        (ctypes.c_int * len(geom))(*geom), vs_d, vs_h, vs_w, w["wpack"].data_ptr(),
        w["small"].data_ptr(), w["w_lat"].data_ptr(), latent.data_ptr(), n, S,
        raw.data_ptr(), torch.cuda.current_stream(rays_o.device).cuda_stream), "nbody_points")
    LAUNCHES["nbody_points"] += 1
    count("nbody_kernel_points", n * S)
    return raw

