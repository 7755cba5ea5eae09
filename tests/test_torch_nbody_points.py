"""Neural Body's point network as one kernel (ops/nbody_points.py,
csrc/nbody_points.cu).

On the CPU:
  * the wrapper (its plain version there) gives `raw` and the 64^2 image
    bit for bit as the torch path it replaced (the chunk loop over
    `NeuralBody.query`, `encodings` and `head` on contiguous channels-first
    volumes), on two seeds, in the configuration's bf16;
  * `check` refuses, naming the reason, what the kernel does not take;
  * `packed_weights` lays each weight where the kernel reads it, rounds as
    the products do, and is rebuilt when a parameter changes;
  * a request capped below its box's pixels (`eval_ray_cap`) renders as the
    replaced path did: its first n box pixels, black elsewhere.

On the card (`-m gpu`; skipped without one), against the plain version on
the card: ragged point counts, points outside every volume, on voxel edges
and at `out_sh`, a frame smaller than the static grid, two latent rows;
a request of the cell capped below its box's pixels; the counter on a
profiled request; a whole request of the cell `nbody-zju-views` within its
`image_rmse` limit of the plain reference.
"""

import pytest
import torch

from benchmark import pool
from gpnerf_tpu_torch.data.base import HumanNVSDataset
from gpnerf_tpu_torch.models.neural_body import NeuralBody
from gpnerf_tpu_torch.ops import nbody_points as nbp
from gpnerf_tpu_torch.ops.compositing import raw2outputs_distance
from gpnerf_tpu_torch.ops.rays import sample_points, sample_z_vals
from gpnerf_tpu_torch.ops.sparse_conv import scatter_dense
from gpnerf_tpu_torch.render.base import batch_to_device, grid_shapes, points_to_dhw_vox
from gpnerf_tpu_torch.render.neural_body import NeuralBodyRender, cut_levels, frame_levels
from gpnerf_tpu_torch.utils import profiling

# tests/test_torch_neural_body.py's cut: 64^2 at 2 cm voxels, widths 8-64
NB = {"code_dim": 8, "out_dim": (8, 16, 32, 32), "width": 64, "view_width": 32,
      "latent_dim": 16, "num_train_frame": 30, "xyz_res": 10, "view_res": 4}
VOXEL = (0.02, 0.02, 0.02)
MAX_OUT_SH = (32, 96, 64)
CFG = {"cam_num": 3, "src_view_num": 3, "mask_bkgd": True,
       "dataset": {"H": 64, "W": 64, "ratio": 1.0, "voxel_size": list(VOXEL)},
       "train": {"n_rays": 1024, "n_samples": 16, "body_sample_ratio": 0.5},
       "tpu": {"max_out_sh": list(MAX_OUT_SH), "site_cap": 4096,
               "level_caps": [2048, 1024, 512, 256], "eval_ray_cap": 4096}}
SEEDS = [2**31 + 2701, 2**31 + 2702]
CELL = "nbody-zju-views"


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _seed_linear_net(net, seed):
    """Kaiming-scaled weights, nonzero biases and BatchNorm statistics
    away from (0, 1), from `seed`."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in net.state_dict().items():
            if not t.is_floating_point():
                continue
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=g))
            elif t.dim() >= 2 and name not in ("c.weight", "latent.weight"):
                fan_in = t.shape[1] if t.dim() == 2 else t[..., 0].numel() // t.shape[-2]
                t.copy_(torch.randn(t.shape, generator=g) * (2.0 / fan_in) ** 0.5)
            else:
                t.copy_(0.2 * torch.randn(t.shape, generator=g))
    return net


def _program(seed):
    net = _seed_linear_net(NeuralBody(n_smpl=6890, compute_dtype=torch.bfloat16, **NB), seed)
    with torch.no_grad():
        net.alpha_fc.bias.fill_(2.0)  # partly opaque: sigma above 0 at some samples
    return NeuralBodyRender(net, voxel_size=VOXEL,
                            max_out_sh=MAX_OUT_SH, n_samples=16, chunk_rays=256).eval()


def _batch(seed, cfg=CFG):
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(seed, 2, pool.img_hw(cfg))
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", cfg)
    hb = pool.build_batches(ds, seed, [0], pool.VIEW_TAG)[0]
    return batch_to_device(hb, torch.device("cpu"))


def _parent_volumes(net, batch, max_out_sh):
    """The volumes as the parent made them: contiguous channels-first."""
    levels = frame_levels(batch, max_out_sh)
    code = net.c.weight[batch["vertex_rows"].clamp_min(0)]
    code = torch.where((batch["vertex_rows"] >= 0)[:, None], code, 0.0)
    vols = []
    for i, f in enumerate(net.xyzc_net.features(code, levels)):
        D, H, W = (int(v) >> (i + 1) for v in batch["out_sh"])
        vol = scatter_dense(f, levels[i + 1]).permute(3, 0, 1, 2).contiguous()
        vols.append(vol[:, :D, :H, :W])
    return vols


def _parent_render(prog, batch):
    """The parent's request: its volumes, its chunk loop over `query`,
    `encodings` and `head`, and the composite."""
    net, S, n = prog.net, prog.n_samples, int(batch["n_rays"])
    vols = _parent_volumes(net, batch, prog.max_out_sh)
    rays_o, rays_d = batch["ray_o"][:n], batch["ray_d"][:n]
    z_vals = sample_z_vals(batch["near"][:n], batch["far"][:n], S, perturb=False)
    latent = net.latent_row(batch["latent_index"])
    raw = rays_o.new_empty(n, S, 4)
    for r0 in range(0, n, prog.chunk_rays):
        r1 = min(n, r0 + prog.chunk_rays)
        o, d = rays_o[r0:r1], rays_d[r0:r1]
        pts = sample_points(o, d, z_vals[r0:r1]).transpose(0, 1).reshape(-1, 3)
        feat = net.query(vols, points_to_dhw_vox(pts, batch, prog.voxel_size), batch["out_sh"])
        view_enc, xyz_enc = net.encodings(pts, d / torch.linalg.norm(d, dim=-1, keepdim=True))
        view_enc = view_enc[None].expand(S, -1, -1).reshape(pts.shape[0], -1)
        out = net.head(feat, latent, view_enc, xyz_enc)
        raw[r0:r1] = out.reshape(S, r1 - r0, 4).transpose(0, 1)
    rgb_map = raw2outputs_distance(raw, z_vals, rays_d)
    H, W = batch["tar_img"].shape[0:2]
    pix = batch["mask_at_box"].reshape(-1).nonzero()[:n, 0]
    pred = rgb_map.new_zeros(3, H * W)
    pred[:, pix] = rgb_map.T
    return raw, pred.reshape(3, H, W)


@pytest.mark.parametrize("seed", SEEDS)
def test_plain_version_equals_the_torch_path_it_replaced(seed):
    prog, batch = _program(seed), _batch(seed)
    n, S = int(batch["n_rays"]), prog.n_samples
    with torch.no_grad():
        want_raw, want_img = _parent_render(prog, batch)
        vols = prog._volume(batch)
        z_vals = sample_z_vals(batch["near"][:n], batch["far"][:n], S, perturb=False)
        raw = nbp.nbody_points(prog.net, vols, batch, batch["ray_o"][:n], batch["ray_d"][:n],
                               z_vals, prog.net.latent_row(batch["latent_index"]),
                               prog.voxel_size, chunk_rays=prog.chunk_rays)
        img = prog.render_demo_fn()(batch)["pred_chw"]
    assert n > 100 and float(want_img.std()) > 0.01
    assert torch.equal(raw, want_raw)
    assert torch.equal(img, want_img)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_frame_that_fills_the_grid_keeps_its_levels_as_they_are(seed):
    batch = _batch(seed)
    assert tuple(int(v) for v in batch["out_sh"]) == MAX_OUT_SH
    for kept, cut in zip(frame_levels(batch, MAX_OUT_SH),
                         cut_levels(batch, grid_shapes(MAX_OUT_SH, 5))):
        assert kept.shape == cut.shape
        for a, b in ((kept.coords, cut.coords), (kept.valid, cut.valid),
                     (kept.nbr, cut.nbr), (kept.down, cut.down)):
            assert (a is None and b is None) or torch.equal(a, b)


@pytest.mark.parametrize("seed", SEEDS)
def test_a_capped_request_renders_its_first_rays_as_the_torch_path(seed):
    cfg = {**CFG, "tpu": {**CFG["tpu"], "eval_ray_cap": 300}}
    prog, batch = _program(seed), _batch(seed, cfg)
    n, box = int(batch["n_rays"]), int(batch["mask_at_box"].sum())
    assert n == 300 < box
    with torch.no_grad():
        _, want_img = _parent_render(prog, batch)
        img = prog.render_demo_fn()(batch)["pred_chw"]
    assert torch.equal(img, want_img)
    # the box pixels past the cap stay black
    pix = batch["mask_at_box"].reshape(-1).nonzero()[:, 0]
    lit = img.reshape(3, -1)[:, pix].abs().sum(dim=0) > 0
    assert bool(lit[:n].any()) and not bool(lit[n:].any())


def _published(compute_dtype=torch.bfloat16):
    return NeuralBody(compute_dtype=compute_dtype)


def _kernel_inputs(n=10, S=64, out_sh=(96, 320, 224), **change):
    """Arguments `check` accepts at the published widths (CPU tensors),
    with the named ones replaced."""
    vols = []
    for i, c in enumerate(nbp.OUT_DIM):
        D, H, W = (v >> (i + 1) for v in out_sh)
        vols.append(torch.zeros(D, H, W, c).permute(3, 0, 1, 2))
    args = {"vols": vols,
            "frame": {"Th": torch.zeros(1, 3), "Rh": torch.eye(3), "bounds": torch.zeros(2, 3),
                      "out_sh": out_sh},
            "rays_o": torch.zeros(n, 3), "rays_d": torch.ones(n, 3),
            "z_vals": torch.zeros(n, S), "latent": torch.zeros(1, 128)}
    args.update(change)
    return args


def _refusals():
    base = _kernel_inputs()
    cf = [v.contiguous() for v in base["vols"]]
    f64 = [v.double() for v in base["vols"]]
    frame64 = dict(base["frame"], Rh=torch.eye(3, dtype=torch.float64))
    return {
        "volume dtype": ({"vols": f64}, NotImplementedError, "volume 0 must be float32"),
        "channels-first volumes": ({"vols": cf}, ValueError, "channels-last"),
        "frame dtype": ({"frame": frame64}, NotImplementedError, "Rh must be float32"),
        "rays not contiguous": ({"rays_o": torch.zeros(3, 10).T}, ValueError,
                                "rays_o must be contiguous"),
        "volume size": ({"vols": base["vols"][:3] + [base["vols"][3][:, :-1]]}, ValueError,
                        "volume 3 has shape"),
        "three volumes": ({"vols": base["vols"][:3]}, ValueError, "3 volumes"),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_check_refuses_what_the_kernel_does_not_take(case):
    change, exc, match = _refusals()[case]
    args = _kernel_inputs(**change)
    with pytest.raises(exc, match=match):
        nbp.check(_published(), **args)


@pytest.mark.parametrize("what", ["widths", "float32"])
def test_check_refuses_another_network(what):
    net = (NeuralBody(compute_dtype=torch.bfloat16, **NB) if what == "widths"
           else _published(compute_dtype=None))
    match = "published widths" if what == "widths" else "computes in bfloat16"
    with pytest.raises(NotImplementedError, match=match):
        nbp.check(net, **_kernel_inputs())


def test_check_takes_the_renderers_volumes_and_returns_the_geometry():
    args = _kernel_inputs(out_sh=(94, 318, 222))
    # the frame's level sizes of the static grid's storage
    static = [torch.zeros(D, H, W, c) for c, (D, H, W) in
              zip(nbp.OUT_DIM, [(48, 160, 112), (24, 80, 56), (12, 40, 28), (6, 20, 14)])]
    args["vols"] = [s.permute(3, 0, 1, 2)[:, :D, :H, :W] for s, (D, H, W) in
                    zip(static, [(47, 159, 111), (23, 79, 55), (11, 39, 27), (5, 19, 13)])]
    geom = nbp.check(_published(), **args)
    assert geom[:3] == [94, 318, 222]
    assert geom[3:8] == [47, 159, 111, 160 * 112 * 32, 112 * 32]
    assert geom[18:23] == [5, 19, 13, 20 * 14 * 128, 14 * 128]


def test_packed_weights_layout_rounding_and_cache():
    net = _seed_linear_net(_published(), 5)
    pk = nbp.packed_weights(net)
    assert nbp.packed_weights(net) is pk
    w = pk["wpack"]
    assert w.dtype == torch.bfloat16 and w.numel() == 43 * 8192 + 11 * 4096

    def at(layer_chunk0, W, n, k, packed=w):
        c, kk = k // 32, k % 32
        off = layer_chunk0 + c * W.shape[0] * 32 + ((n >> 3) * 4 + (kk >> 3)) * 64 \
            + (n & 7) * 8 + (kk & 7)
        return packed[off]

    for chunk0, W, cols in ((0, net.fc_0.weight, 352), (11 * 8192, net.fc_1.weight, 256),
                            (35 * 8192, net.latent_fc.weight, 256),
                            (43 * 8192, net.view_fc.weight, 346)):
        for n, k in ((0, 0), (7, 31), (37, 77), (W.shape[0] - 1, cols - 1)):
            assert at(chunk0, W, n, k) == W[n, k].to(torch.bfloat16)
    # view_fc's K padding is zero
    assert at(43 * 8192, net.view_fc.weight, 5, 350) == 0
    small = pk["small"]
    assert torch.equal(small[256:512], net.fc_1.bias.to(torch.bfloat16).float())
    assert torch.equal(small[1280:1408], net.view_fc.bias.to(torch.bfloat16).float())
    assert torch.equal(small[1408:1664], net.alpha_fc.weight[0].to(torch.bfloat16).float())
    assert float(small[2048]) == float(net.alpha_fc.bias.detach())  # float32, not rounded
    assert torch.equal(small[2049:2052], net.rgb_fc.bias)
    assert torch.equal(pk["w_lat"], net.latent_fc.weight[:, 256:].to(torch.bfloat16))
    with torch.no_grad():
        net.fc_2.weight.mul_(2)
    again = nbp.packed_weights(net)
    assert again is not pk
    assert at(19 * 8192, net.fc_2.weight, 3, 100, again["wpack"]) == \
        net.fc_2.weight[3, 100].to(torch.bfloat16)


# ---- on the card ----------------------------------------------------------

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# Kernel against the plain version on the card, both in bf16: the kernel
# sums each product in another order than cuBLAS and folds latent_fc's
# latent half into its bias, so a hidden activation that lies near a bf16
# rounding boundary rounds the other way in one of them (one bf16 step,
# 2^-8 of its value) and the flip runs on through the later layers. Over
# each raw channel's range, on an H100: frame 0 of the cell reads a mean
# error of at most 1.0e-6 and a largest of 4.6e-3 (rgb; sigma 2.6e-7); the
# cases here at most 1.6e-5 (edges) and 4.2e-3 (ragged). The limits leave
# about five times that: mean 1e-4, largest 2e-2.
MEAN_TOL, MAX_TOL = 1e-4, 2e-2
STATIC = (40, 72, 56)


def _card_case(kind, device, seed=11):
    g = torch.Generator().manual_seed(seed)
    net = _seed_linear_net(_published(), seed).to(device)
    out_sh = (36, 64, 52) if kind == "smaller frame" else STATIC
    vols = []
    for i, c in enumerate(nbp.OUT_DIM):
        Dm, Hm, Wm = (v >> (i + 1) for v in STATIC)
        D, H, W = (v >> (i + 1) for v in out_sh)
        store = torch.randn(Dm, Hm, Wm, c, generator=g)
        vols.append(store.to(device).permute(3, 0, 1, 2)[:, :D, :H, :W])
    vs = 2.0 ** -6
    voxel = (vs, vs, vs)
    if kind in ("edges", "outside"):
        # Th 0, Rh I, bounds 0 and a power-of-two voxel: a point's voxel
        # coordinates are exact
        frame = {"Th": torch.zeros(1, 3), "Rh": torch.eye(3), "bounds": torch.zeros(2, 3)}
        if kind == "edges":
            k = torch.randint(0, 9, (2000, 3), generator=g).float()
            sh = torch.tensor(out_sh[::-1], dtype=torch.float32)  # xyz
            vox = torch.where(k < 3, k * sh / 8, torch.where(k < 6, sh - (k - 3) * 0.5, sh))
            vox = torch.where(k == 8, torch.floor(torch.rand(2000, 3, generator=g) * sh), vox)
        else:
            # one coordinate beyond the volumes by their whole extent (a
            # point within one level voxel of the edge still reads it)
            sh = torch.tensor(out_sh[::-1], dtype=torch.float32)
            vox = torch.rand(1500, 3, generator=g) * sh * 3 - sh
            axis = torch.randint(0, 3, (1500,), generator=g)
            far = (2 + torch.rand(1500, generator=g)) * sh[axis]
            far = torch.where(torch.rand(1500, generator=g) < 0.5, far, -far)
            vox[torch.arange(1500), axis] = far
        rays_o = vox * vs
        rays_d = torch.randn(rays_o.shape[0], 3, generator=g)
        z_vals = torch.zeros(rays_o.shape[0], 1)
    else:
        a = torch.randn(3, generator=g)
        R, _ = torch.linalg.qr(torch.randn(3, 3, generator=g))
        frame = {"Th": 0.1 * a.reshape(1, 3), "Rh": R.contiguous(),
                 "bounds": torch.stack([torch.tensor([-0.45, -0.2, -0.35]),
                                        torch.tensor([0.45, 1.0, 0.35])])}
        n = 777 if kind == "ragged" else 1024
        rays_o = torch.tensor([0.0, 0.4, -2.0]) + 0.05 * torch.randn(n, 3, generator=g)
        rays_d = torch.tensor([0.0, 0.0, 1.0]) + 0.2 * torch.randn(n, 3, generator=g)
        S = 13 if kind == "ragged" else 64
        near = 1.3 + 0.1 * torch.rand(n, generator=g)
        z_vals = sample_z_vals(near, near + 1.4, S, perturb=False)
    frame = {k: v.to(device) for k, v in frame.items()}
    frame["out_sh"] = out_sh
    return (net, vols, frame, rays_o.to(device), rays_d.to(device), z_vals.to(device).contiguous(),
            voxel)


def _compare(got, want):
    assert got.shape == want.shape and bool(torch.isfinite(got).all())
    scale = want.abs().flatten(0, 1).amax(dim=0).clamp_min(1e-6)
    rel = ((got - want).abs() / scale).flatten(0, 1)
    assert float(rel.mean()) < MEAN_TOL, rel.mean(dim=0)
    assert float(rel.max()) < MAX_TOL, rel.amax(dim=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["ragged", "outside", "edges", "smaller frame", "latents"])
def test_kernel_matches_the_plain_version_on_the_card(kind):
    device = _cuda()
    net, vols, frame, rays_o, rays_d, z_vals, voxel = _card_case(kind, device)
    rows = [0, 7] if kind == "latents" else [3]
    with torch.no_grad():
        outs = []
        for row in rows:
            latent = net.latent_row(torch.tensor(row, device=device))
            launches = nbp.LAUNCHES["nbody_points"]
            got = nbp.nbody_points(net, vols, frame, rays_o, rays_d, z_vals, latent, voxel)
            assert nbp.LAUNCHES["nbody_points"] == launches + 1
            want = nbp.nbody_points_plain(net, vols, frame, rays_o, rays_d, z_vals, latent,
                                          voxel)
            _compare(got, want)
            outs.append(got)
    if kind == "outside":
        # no volume reaches any point: the query is zero, as the plain version's
        assert float(want[..., 3].std()) < 1e-6
    if kind == "latents":
        assert torch.equal(outs[0][..., 3], outs[1][..., 3])
        assert float((outs[0][..., :3] - outs[1][..., :3]).abs().max()) > 1e-2


def _cell_request(device, ray_cap=None):
    """The cell's program (its seeded checkpoint) and one request at 64^2,
    with `eval_ray_cap` set to `ray_cap` if given."""
    from benchmark import system
    from benchmark.harness import Spec

    conf = Spec(CELL).conf
    cfg = conf["cfg"]
    cfg["dataset"]["H"] = cfg["dataset"]["W"] = 64
    if ray_cap is not None:
        cfg["tpu"]["eval_ray_cap"] = ray_cap
    prog = system.views_program(conf, device)
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(SEEDS[0], 2, pool.img_hw(cfg))
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", cfg)
    batch = system.to_device(pool.build_batches(ds, SEEDS[0], [0], pool.VIEW_TAG)[0], device)
    return prog, batch, cfg


@pytest.mark.gpu
def test_a_capped_request_matches_the_plain_version_on_the_card():
    device = _cuda()
    prog, batch, _ = _cell_request(device, ray_cap=256)
    n, box = int(batch["n_rays"]), int(batch["mask_at_box"].sum())
    assert n == 256 < box
    with torch.no_grad():
        img = prog.render_demo_fn()(batch)["pred_chw"]
        vols = prog._volume(batch)
        z_vals = sample_z_vals(batch["near"][:n], batch["far"][:n], prog.n_samples,
                               perturb=False)
        args = (prog.net, vols, batch, batch["ray_o"][:n], batch["ray_d"][:n], z_vals,
                prog.net.latent_row(batch["latent_index"]), prog.voxel_size)
        got, want = nbp.nbody_points(*args), nbp.nbody_points_plain(*args)
        want_img = prog._composite(batch, want, z_vals, n)["pred_chw"]
    _compare(got, want)
    # the image: the first n box pixels lit, within the raw's error of the
    # plain version's, and black past the cap in both
    pix = batch["mask_at_box"].reshape(-1).nonzero()[:, 0]
    lit = img.reshape(3, -1)[:, pix].abs().sum(dim=0) > 0
    assert bool(lit[:n].all()) and not bool(lit[n:].any())
    assert float((img - want_img).abs().max()) < MAX_TOL


@pytest.mark.gpu
def test_kernel_counts_every_point_of_a_profiled_request():
    device = _cuda()
    prog, batch, cfg = _cell_request(device)
    profiling.reset_counters()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]):
            prog.render_demo_fn()(batch)
            torch.cuda.synchronize()
        c = profiling.counters()
    finally:
        profiling.reset_counters()
    assert c["nbody_points"] == int(batch["n_rays"]) * cfg["train"]["n_samples"] > 0
    assert c["nbody_kernel_points"] == c["nbody_points"]


@pytest.mark.gpu
def test_a_whole_request_passes_the_cells_limit():
    from benchmark import calibrate
    from benchmark.harness import Spec

    device = _cuda()
    spec = Spec(CELL)
    limits = spec.conf["limits"]["views"]
    assert limits == {"image_rmse": 0.016}
    out = calibrate.view_readings(spec, SEEDS[:1], set(), device)
    numbers = out["program"][SEEDS[0]]
    assert numbers["image_rmse"] < limits["image_rmse"], numbers
