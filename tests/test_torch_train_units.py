"""Pieces of the port's training path against the JAX package, on seeded
numpy inputs at the size of tests/test_bf16_train.py (tiny encoder, 128^2,
code_dim 16, 256 rays x 8 samples): compositing, stratified sampling with
JAX's own uniform draws, the sparse index volumes and trilinear query,
projection, train-mode MaskedBatchNorm, the learning-rate schedules, the
criterion, SSIM, the samplers' index order and the fresh-init statistics;
plus the port's own invariants (eval BatchNorm bitwise as before, the dense
and sparse query contexts equal) and the no-JAX-import rule."""

import ast
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gpnerf_tpu.data.loader as jloader
import gpnerf_tpu.ops.compositing as jcomp
import gpnerf_tpu.ops.sparse_conv as jsc
import gpnerf_tpu.train.lr as jlr
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.layers import MaskedBatchNorm as JaxBN
from gpnerf_tpu.ops.projection import project_and_gather as jax_project_and_gather
from gpnerf_tpu.ops.rays import sample_points as jax_sample_points
from gpnerf_tpu.ops.rays import sample_z_vals as jax_sample_z_vals
from gpnerf_tpu.ops.ssim import compare_ssim as jax_ssim
from gpnerf_tpu.registry import get as jax_get
import gpnerf_tpu_torch.data.loader as ploader
import gpnerf_tpu_torch.ops.compositing as pcomp
import gpnerf_tpu_torch.ops.sparse_conv as psc
import gpnerf_tpu_torch.train.lr as plr
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.layers import MaskedBatchNorm
from gpnerf_tpu_torch.ops.projection import project_and_gather
from gpnerf_tpu_torch.ops.rays import sample_points, sample_z_vals
from gpnerf_tpu_torch.ops.ssim import compare_ssim
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, build_render, grid_shapes

ROOT = os.path.join(os.path.dirname(__file__), "..")


def small_cfg(base):
    """The training test size of tests/test_bf16_train.py:20-28."""
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.encoder.name = "tiny"
    cfg.dataset.H = 128
    cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 16
    cfg.train.n_rays = 256
    cfg.train.n_samples = 8
    cfg.tpu.eval_ray_cap = 4096
    cfg.tpu.eval_chunk = 1024
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Many small torch ops: with the test files run in parallel, a thread
    per core for each op costs more than it saves."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frame():
    """One seeded training item of the synthetic set, as numpy (for JAX)
    and as CPU tensors (for the port)."""
    cfg = small_cfg(jax_cfg)
    random.seed(0)
    np.random.seed(0)
    b = jax_get("dataset", cfg.dataset.train.file)(cfg, is_train=True)[0]
    return b, batch_to_device(b, "cpu")


def test_raw2outputs_matches_jax():
    rs = np.random.RandomState(0)
    raw = rs.randn(64, 16, 4).astype(np.float32)
    raw[..., 3] = np.abs(raw[..., 3]) * 2
    z = np.sort(rs.rand(64, 16).astype(np.float32) * 3 + 1, axis=1)
    pm = rs.rand(64, 16) > 0.3
    for neg in (False, True):
        j = jcomp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(pm), neg=neg)
        p = pcomp.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z), torch.from_numpy(pm),
                              neg=neg)
        for name in ("rgb_map", "disp_map", "acc_map", "weights", "depth_map", "alpha"):
            np.testing.assert_allclose(getattr(p, name).numpy(), np.asarray(getattr(j, name)),
                                       rtol=1e-5, atol=1e-6, err_msg=f"{name} neg={neg}")
        assert np.array_equal(p.mask.numpy(), np.asarray(j.mask))
    rgb_j, w_j = jcomp.composite_scattered(jnp.asarray(raw[..., :3].reshape(-1, 3)),
                                           jnp.asarray(1 - np.exp(-raw[..., 3]).reshape(-1)), 64, 16)
    rgb_p, w_p = pcomp.composite_scattered(torch.from_numpy(raw[..., :3].reshape(-1, 3)),
                                           torch.from_numpy(1 - np.exp(-raw[..., 3]).reshape(-1)),
                                           64, 16)
    np.testing.assert_allclose(rgb_p.numpy(), np.asarray(rgb_j), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(w_p.numpy(), np.asarray(w_j), rtol=1e-5, atol=1e-6)


def test_sample_z_vals_with_jax_draws():
    """Given the uniform draws JAX makes (jax.random.uniform(rng, z.shape)),
    the stratified samples agree to float32 rounding (1e-6 relative)."""
    rs = np.random.RandomState(1)
    near = (rs.rand(50) + 1).astype(np.float32)
    far = near + rs.rand(50).astype(np.float32) + 0.5
    rng = jax.random.PRNGKey(3)
    zj = jax_sample_z_vals(jnp.asarray(near), jnp.asarray(far), 8, perturb=True, rng=rng)
    t_rand = np.asarray(jax.random.uniform(rng, (50, 8)))
    zp = sample_z_vals(torch.from_numpy(near), torch.from_numpy(far), 8, perturb=True,
                       t_rand=torch.from_numpy(t_rand))
    np.testing.assert_allclose(zp.numpy(), np.asarray(zj), rtol=1e-6)
    z0j = jax_sample_z_vals(jnp.asarray(near), jnp.asarray(far), 8, perturb=False)
    z0p = sample_z_vals(torch.from_numpy(near), torch.from_numpy(far), 8, perturb=False)
    np.testing.assert_allclose(z0p.numpy(), np.asarray(z0j), rtol=1e-6)
    o, d = rs.randn(50, 3).astype(np.float32), rs.randn(50, 3).astype(np.float32)
    np.testing.assert_allclose(
        sample_points(torch.from_numpy(o), torch.from_numpy(d), zp).numpy(),
        np.asarray(jax_sample_points(jnp.asarray(o), jnp.asarray(d), zj)), rtol=1e-5, atol=1e-6)
    # a generator's draws are uniform in [0, 1) and jitter within the strata
    g = torch.Generator().manual_seed(0)
    zg = sample_z_vals(torch.from_numpy(near), torch.from_numpy(far), 8, perturb=True, generator=g)
    assert bool((zg >= torch.from_numpy(near)[:, None]).all() and (zg <= torch.from_numpy(far)[:, None]).all())
    assert bool((zg[:, 1:] >= zg[:, :-1]).all())


def _levels(b, pb):
    shapes = grid_shapes(tuple(small_cfg(jax_cfg).tpu.max_out_sh))
    i32 = lambda k: jnp.asarray(b[k]).astype(jnp.int32)
    return [(jsc.SparseLevel(i32(f"lvl{i}_coords"), jnp.asarray(b[f"lvl{i}_valid"]),
                             i32(f"lvl{i}_nbr"), None, shapes[i]),
             psc.SparseLevel(pb[f"lvl{i}_coords"], pb[f"lvl{i}_valid"], pb[f"lvl{i}_nbr"], None,
                             shapes[i]))
            for i in range(1, 5)]


def test_index_volume_and_trilinear_query(frame):
    """Index volumes bitwise (every invalid row dropped), the trilinear
    sparse query within 1e-5 of JAX, at in-range and out-of-range
    positions."""
    b, pb = frame
    rs = np.random.RandomState(2)
    for jl, pl in _levels(b, pb):
        vj = jsc.build_index_volume(jl.coords, jl.valid, jl.shape)
        vp = psc.build_index_volume(pl.coords, pl.valid, pl.shape)
        assert np.array_equal(vp.numpy(), np.asarray(vj))
        assert int((vp >= 0).sum()) == int(pl.valid.sum())
        coords = rs.randint(-2, max(pl.shape) + 2, size=(500, 3))
        assert np.array_equal(psc._lookup(vp, torch.from_numpy(coords), pl.shape).numpy(),
                              np.asarray(jsc._lookup(vj, jnp.asarray(coords, jnp.int32), jl.shape)))
        feats = rs.randn(pl.coords.shape[0], 8).astype(np.float32)
        act = pl.coords[pl.valid].float().numpy()
        pos = np.concatenate([act[rs.randint(0, len(act), 400)] + rs.rand(400, 3) * 2 - 1,
                              rs.rand(100, 3) * np.asarray(pl.shape) * 1.2 - 3]).astype(np.float32)
        size = np.asarray(pl.shape, np.int32) - rs.randint(0, 3, 3).astype(np.int32)
        oj = jsc.trilinear_sparse_rows(jnp.asarray(feats), vj, jl.shape, jnp.asarray(pos),
                                       dyn_size=jnp.asarray(size))
        op = psc.trilinear_sparse_rows(torch.from_numpy(feats), vp, pl.shape, torch.from_numpy(pos),
                                       dyn_size=torch.from_numpy(size))
        np.testing.assert_allclose(op.numpy(), np.asarray(oj), rtol=1e-5, atol=1e-5)
        rows = rs.randint(-1, pl.coords.shape[0], 300)
        np.testing.assert_array_equal(
            psc._gather_rows(torch.from_numpy(feats), torch.from_numpy(rows)).numpy(),
            np.asarray(jsc._gather_rows(jnp.asarray(feats), jnp.asarray(rows))))


def test_sparse_and_dense_query_contexts_agree(frame):
    """`point_forward`'s two query contexts read the same volume: the
    sparse rows through index volumes and the materialized dense volumes
    (1e-6)."""
    b, pb = frame
    cfg = small_cfg(port_cfg)
    r = build_render(cfg, device="cpu").init_variables(0)
    rs = np.random.RandomState(3)
    levels = [psc.SparseLevel(pb[f"lvl{i}_coords"], pb[f"lvl{i}_valid"], pb[f"lvl{i}_nbr"],
                              pb.get(f"lvl{i}_down"), s)
              for i, s in enumerate(grid_shapes(r.max_out_sh))]
    feats = [torch.from_numpy(rs.randn(levels[i + 1].coords.shape[0], 32).astype(np.float32))
             for i in range(4)]
    out_sh = torch.as_tensor(np.asarray(b["out_sh"]))
    act = levels[0].coords[levels[0].valid].float()
    dhw = act[torch.from_numpy(rs.randint(0, len(act), 256))] + torch.rand(256, 3) * 4 - 2
    net = r.nerfhead.sigmahead.xyzc_net
    sparse = net.query_sparse(*r.sparse_query_ctx(feats, levels)["sparse"], dhw, out_sh)
    dense = net.query_dense(r.materialize_dense(feats, levels), dhw, out_sh)
    np.testing.assert_allclose(sparse.numpy(), dense.numpy(), rtol=1e-6, atol=1e-6)
    assert float(sparse.abs().sum()) > 0


def test_project_and_gather_matches_jax(frame):
    """Masks bitwise, gathered rgb/features within 1e-4 (median 1e-6)."""
    b, pb = frame
    from gpnerf_tpu.render.base import camera_matrices as jax_cam
    from gpnerf_tpu_torch.render.base import camera_matrices

    rs = np.random.RandomState(4)
    c = b["bounds"].mean(0)
    pts = (c + (rs.rand(2000, 3) - 0.5) * (b["bounds"][1] - b["bounds"][0]) * 1.4).astype(np.float32)
    src = (b["src_imgs"].astype(np.float32) / 255.0)
    fm = rs.randn(3, 32, 32, 16).astype(np.float32)
    H, W = src.shape[1:3]
    rj, mj = jax_project_and_gather(jnp.asarray(pts), jax_cam({k: jnp.asarray(v) for k, v in b.items()}),
                                    jnp.asarray(src), jnp.asarray(fm), H, W)
    rp, mp = project_and_gather(torch.from_numpy(pts), camera_matrices(pb), torch.from_numpy(src),
                                torch.from_numpy(fm), H, W)
    assert np.array_equal(mp.numpy(), np.asarray(mj))
    assert 0.05 < float(mp.mean()) < 1.0
    # the projected pixel coordinates (|x| ~ 10^2) differ in their last bit
    # (XLA contracts the projection into FMAs), which moves the bilinear
    # weights by ~1e-5 of a pixel on these unsmooth random feature maps
    np.testing.assert_allclose(rp.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-4)
    assert np.median(np.abs(rp.numpy() - np.asarray(rj))) < 1e-6


def test_masked_batchnorm_train_mode_matches_flax():
    """Outputs (1e-5), gradients (1e-5 relative L2) and the new running
    statistics against flax's mutated batch_stats (1e-6); the count of
    updates moves by one."""
    rs = np.random.RandomState(5)
    N, C = 3000, 8
    x = (rs.randn(N, C) * 2 + 1).astype(np.float32)
    valid = rs.rand(N) < 0.8
    x[~valid] = 0
    up = rs.randn(N, C).astype(np.float32)
    sc = (1 + 0.1 * rs.randn(C)).astype(np.float32)
    bi = (0.1 * rs.randn(C)).astype(np.float32)
    rm = (0.1 * rs.randn(C)).astype(np.float32)
    rv = (1 + 0.1 * rs.rand(C)).astype(np.float32)
    bn = JaxBN()

    def f(p, x):
        y, mut = bn.apply({"params": p, "batch_stats": {"mean": rm, "var": rv}}, x,
                          jnp.asarray(valid), use_running_average=False, mutable=["batch_stats"])
        return (y * up).sum(), (y, mut["batch_stats"])

    (_, (yj, stats)), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {"scale": sc, "bias": bi}, x)
    m = MaskedBatchNorm(C)
    with torch.no_grad():
        m.weight.copy_(torch.from_numpy(sc))
        m.bias.copy_(torch.from_numpy(bi))
        m.running_mean.copy_(torch.from_numpy(rm))
        m.running_var.copy_(torch.from_numpy(rv))
    tx = torch.from_numpy(x).requires_grad_()
    y = m(tx, torch.from_numpy(valid), train=True)
    (y * torch.from_numpy(up)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-6)
    np.testing.assert_allclose(m.running_var.numpy(), np.asarray(stats["var"]), atol=1e-6)
    assert int(m.num_batches_tracked) == 1
    for got, ref in ((tx.grad, gx), (m.weight.grad, gp["scale"]), (m.bias.grad, gp["bias"])):
        ref = np.asarray(ref)
        assert np.linalg.norm(got.numpy() - ref) <= 1e-5 * np.linalg.norm(ref)


def test_masked_batchnorm_eval_is_bitwise_unchanged():
    """Eval mode (what every render path runs) gives exactly the values of
    the eval-only form the renderers used before train mode existed."""
    rs = np.random.RandomState(6)
    m = MaskedBatchNorm(32)
    with torch.no_grad():
        for t in (m.weight, m.bias, m.running_mean):
            t.copy_(torch.from_numpy(rs.randn(32).astype(np.float32)))
        m.running_var.copy_(torch.from_numpy(rs.rand(32).astype(np.float32) + 0.1))
    x = torch.from_numpy(rs.randn(5000, 32).astype(np.float32))
    before = (x - m.running_mean) / torch.sqrt(m.running_var + m.eps) * m.weight + m.bias
    valid = torch.from_numpy(rs.rand(5000) < 0.5)
    for out in (m(x), m(x, valid), m(x, valid, train=False)):
        assert torch.equal(out, before)
    assert int(m.num_batches_tracked) == 0


@pytest.mark.parametrize("steps", [[0, 1, 49, 50, 51, 499, 500, 5000, 49999, 50000]])
def test_lr_schedules_match_jax(steps):
    """All three schedules, bitwise on integer step counts: the epoch is
    floored (one change per ep_iter steps)."""
    pairs = [
        (jlr.exponential_epoch_schedule(1e-4, 0.1, 1000, 50),
         plr.exponential_epoch_schedule(1e-4, 0.1, 1000, 50)),
        (jlr.multistep_epoch_schedule(1e-3, [2, 5, 300], 0.5, 50),
         plr.multistep_epoch_schedule(1e-3, [2, 5, 300], 0.5, 50)),
        (jlr.warmup_multistep_epoch_schedule(1e-3, [20, 600], 0.1, 1 / 3, 10, 50),
         plr.warmup_multistep_epoch_schedule(1e-3, [20, 600], 0.1, 1 / 3, 10, 50)),
        (jlr.warmup_multistep_epoch_schedule(1e-3, [20], 0.1, 0.25, 10, 50, "constant"),
         plr.warmup_multistep_epoch_schedule(1e-3, [20], 0.1, 0.25, 10, 50, "constant")),
    ]
    for j, p in pairs:
        assert [p(s) for s in steps] == [j(s) for s in steps]
    exp = pairs[0][1]
    assert exp(49) == exp(0) and exp(50) < exp(49)  # per-epoch staircase


def test_criterion_matches_jax():
    """The validity-weighted MSE within 1e-6 relative."""
    from gpnerf_tpu.train.criterion import Criterion as JaxCriterion
    from gpnerf_tpu_torch.train.criterion import Criterion

    rs = np.random.RandomState(7)
    ret = {"rgb_map": rs.rand(300, 3).astype(np.float32)}
    batch = {"rgb": rs.rand(300, 3).astype(np.float32),
             "ray_valid": (rs.rand(300) < 0.7).astype(np.float32)}
    j = JaxCriterion(None)({k: jnp.asarray(v) for k, v in ret.items()},
                           {k: jnp.asarray(v) for k, v in batch.items()})
    p = Criterion(None)({k: torch.from_numpy(v) for k, v in ret.items()},
                        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(p) == set(j) == {"rgb_loss"}
    np.testing.assert_allclose(float(p["rgb_loss"]), float(j["rgb_loss"]), rtol=1e-6)
    empty = {"rgb": torch.zeros(4, 3), "ray_valid": torch.zeros(4)}
    assert float(Criterion(None)({"rgb_map": torch.ones(4, 3)}, empty)["rgb_loss"]) == 0.0


def test_ssim_matches_jax():
    rs = np.random.RandomState(8)
    a = rs.rand(40, 30, 3)
    b = np.clip(a + 0.1 * rs.randn(40, 30, 3), 0, 1)
    assert compare_ssim(a, b, multichannel=True) == jax_ssim(a, b, multichannel=True)
    assert compare_ssim(a[..., 0], b[..., 0]) == jax_ssim(a[..., 0], b[..., 0])


def test_loader_index_order_matches_jax():
    """Samplers and batch samplers yield JAX's index order for one seed."""
    cfg_j, cfg_p = small_cfg(jax_cfg), small_cfg(port_cfg)
    random.seed(0)
    np.random.seed(0)
    tr_j = jax_get("dataset", cfg_j.dataset.train.file)(cfg_j, is_train=True)
    te_j = jax_get("dataset", cfg_j.dataset.test.file)(cfg_j, is_train=False)
    tr_p = port_get("dataset", cfg_p.dataset.train.file)(cfg_p, is_train=True)
    for seed in (0, 11):
        assert list(ploader.RandomSampler(tr_p, seed)) == list(jloader.RandomSampler(tr_j, seed))
    assert list(ploader.SequentialSampler(tr_p)) == list(jloader.SequentialSampler(tr_j))
    assert list(ploader.FrameSampler(te_j)) == list(jloader.FrameSampler(te_j))
    for bs, drop in ((4, True), (4, False), (7, False)):
        jb = jloader.BatchSampler(jloader.RandomSampler(tr_j, 3), bs, drop)
        pb = ploader.BatchSampler(ploader.RandomSampler(tr_p, 3), bs, drop)
        assert list(pb) == list(jb) and len(pb) == len(jb)
        it_j = jloader.IterationBasedBatchSampler(jloader.BatchSampler(
            jloader.RandomSampler(tr_j, 5), bs, drop), 37)
        it_p = ploader.IterationBasedBatchSampler(ploader.BatchSampler(
            ploader.RandomSampler(tr_p, 5), bs, drop), 37)
        assert list(it_p) == list(it_j) and len(list(it_p)) == 37
    # the built train sampler: ep_iter batches of one index, JAX's order
    sj = jloader.build_batchsampler(cfg_j, tr_j, False, 1, True)
    sp = ploader.build_batchsampler(cfg_p, tr_p, 1, True, seed=9)
    sj.batch_sampler.sampler.rng = np.random.default_rng(9)
    assert list(sp) == list(sj) and len(sp) == cfg_p.train.ep_iter
    loader = ploader.DataLoader(tr_p, ploader.build_batchsampler(cfg_p, tr_p, 1, True, seed=9),
                                prefetch=0)
    assert len(loader) == cfg_p.train.ep_iter
    cfg_bad = cfg_p.clone()
    cfg_bad.defrost()
    cfg_bad.dataset.train.batch_sampler = "image_size"
    with pytest.raises(NotImplementedError, match="batch_sampler"):
        ploader.build_batchsampler(cfg_bad, tr_p, 1, True)


def test_fresh_init_statistics_match_flax(frame):
    """`init_variables` draws from the JAX package's initializers: per
    tensor the same shape, ones/zeros exactly where flax has them, and
    mean and standard deviation within sampling error of flax's draw (for
    n elements: |d mean| <= 6 sigma / sqrt(n), std within 12% for n >= 500
    and 35% below)."""
    b, _ = frame
    from gpnerf_tpu_torch.train.checkpoint import from_jax_variables

    jr = jax_get("render", "BaseRender")(small_cfg(jax_cfg))
    jv = jax.tree.map(np.asarray, jax.jit(jr._init_variables_impl)(
        jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in b.items()}))
    ref = from_jax_variables(jv)
    port = build_render(small_cfg(port_cfg), device="cpu").init_variables(123).state_dict()
    assert set(port) == set(ref)
    for k, r in ref.items():
        p = port[k]
        assert p.shape == r.shape, k
        if k.endswith("num_batches_tracked"):
            assert int(p) == 0
            continue
        r, p = r.double(), p.double()
        if float(r.std()) == 0.0 or r.numel() == 1:
            assert torch.equal(p, r), k
            continue
        n = r.numel()
        assert abs(float(p.mean() - r.mean())) <= 6 * float(r.std()) / n ** 0.5, k
        tol = 0.12 if n >= 500 else 0.35
        assert abs(float(p.std()) / float(r.std()) - 1) <= tol, (k, float(p.std()), float(r.std()))


def test_port_imports_no_jax():
    """No file of gpnerf_tpu_torch/, tools/train_torch.py or chip_smoke.py
    imports jax, flax or gpnerf_tpu."""
    files = [os.path.join(ROOT, "tools", "train_torch.py"), os.path.join(ROOT, "chip_smoke.py")]
    for d, _, names in os.walk(os.path.join(ROOT, "gpnerf_tpu_torch")):
        files += [os.path.join(d, n) for n in names if n.endswith(".py")]
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = []
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                mods = [node.module]
            bad += [(path, m) for m in mods if m.split(".")[0] in ("jax", "flax", "gpnerf_tpu")]
    assert len(files) > 30 and not bad, bad
