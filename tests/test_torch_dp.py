"""Data parallelism in the port (gpnerf_tpu_torch/utils/dist.py,
data/loader.DistributedSampler, parallel/dp.py) against the JAX package's
(utils/dist.py, data/loader.py, parallel/dp.py), on the CPU.

`DistributedSampler` equals JAX's for any (n, replicas, rank, epoch,
shuffle). The rest runs in one launch of two real gloo processes (this file
run as a script, `python tests/test_torch_dp.py <dir> <coordinator> <world>
<rank>`, importing only torch and the port), each reporting its checks to
`<dir>`:

  * the control plane, as tests/test_dist_multiprocess.py holds JAX's: rank
    gating, `reduce_dict`, `all_gather`, `barrier` and the sampler's rank
    slices;
  * one `make_dp_train_step` step, against JAX's `make_dp_train_step` on a
    2-device mesh of tests/conftest.py's virtual CPU devices, at
    tests/test_parallel.py's size (tiny encoder, 128^2, 64 rays x 16
    samples), from the same JAX-initialized variables (rank 1 perturbs its
    copy first: the step's broadcast must undo it), each rank on its frame
    with JAX's draws `jax.random.uniform(rngs[i], (n_rays, n_samples))`.
    Held: the averaged gradients key by key with tests/test_parallel.py
    `test_dp_matches_manual_grad_mean`'s scale-aware tolerance (5% of the
    leaf's scale) against JAX's mean gradient of the two frames taken, as
    tests/test_torch_train_step.py takes it, with float64 norm statistics
    (JAX's float32 ones put its gradients 0.5-1% off the exact ones, and
    single elements of the sparse weights up to 8% of their leaf's scale;
    the port takes them in float64), the
    averaged running statistics within 1e-6 and the averaged metrics (loss
    within 1e-5 relative) of JAX's pmeans, the parameters after AdamW
    within tests/test_torch_train_step.py's tolerance (1e-6, or 2 lr plus
    the float32 rounding of the two results where the two steps' Adam
    directions differ in sign or are not saturated, on at most 0.5% of the
    elements), and both ranks' parameters and
    statistics bitwise equal;
  * the 2-rank `make_dp_demo_render` against the single-process render of
    the same frame (tests/test_parallel.py's demo configuration): ray_ok,
    pixel indices, mask, counts and overflows bitwise, colors within 1e-4;
    the overflow counters of a stub renderer's slices summed as
    `test_dp_demo_overflow_aggregation` holds them;
  * the 2-rank `make_dp_eval_render` against the unsharded `render_eval`.
"""

import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2
SMALL = {
    "encoder.name": "tiny", "dataset.H": 128, "dataset.W": 128, "head.sigma.code_dim": 16,
    "train.n_rays": 64, "train.n_samples": 16, "tpu.site_cap": 8192,
    "tpu.level_caps": [20480, 10240, 4096, 2048], "tpu.eval_ray_cap": 4096,
    "tpu.eval_chunk": 1024,
}
# the progressive render with the trained checkpoint at 128^2: the second of
# two bench frames (test item 30, seed 1) has 8,284 rays, so a ray cap of 12288 drops
# none and splits them 6,144 / 2,140 over two ranks
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
DEMO = {"encoder.name": "resnet34", "head.sigma.code_dim": 32, "render.file": "demo_render",
        "tpu.ray_cap": 12288}
DEMO_ITEM = 30


def small_cfg(base, **extra):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    for k, v in {**SMALL, **extra}.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = node[p]
        node[leaf] = v
    cfg.freeze()
    return cfg


# --------------------------------------------------------------------------
# the worker: one rank, torch and the port only
# --------------------------------------------------------------------------


class _StubDemo:
    """A renderer whose slices count shard-dependent overflows: a slice
    whose `near` holds [4i .. 4i + 3]-style values reports its sum as the
    per-ray overflow and its max as the sigma overflow."""

    ray_cap = 16

    def encoder(self, imgs):
        return imgs

    def _frame_stage(self, batch, featmaps):
        cap = self.ray_cap
        rd = {"rays_o": torch.zeros(cap, 3), "rays_d": torch.zeros(cap, 3),
              "near": torch.arange(cap, dtype=torch.float32), "far": torch.zeros(cap),
              "zmin": torch.zeros(cap), "bins": None, "ray_ok": torch.ones(cap, dtype=torch.bool),
              "pix_idx": torch.arange(cap), "ray_overflow": torch.tensor(3),
              "can_bounds": torch.zeros(2, 3)}
        return None, None, rd

    def _ray_pipeline(self, batch, pre, tables, rd):
        near = rd["near"]
        stats = {"perray_overflow": near.sum().long(), "sig_overflow": near.max().long(),
                 "n_sigma": torch.tensor(len(near)), "n_rgb": torch.tensor(1)}
        return torch.zeros(near.shape[0], 3), stats


def _worker(out_dir, coordinator, world, rank):
    from gpnerf_tpu_torch.config import cfg as port_cfg
    from gpnerf_tpu_torch.data.loader import DistributedSampler
    from gpnerf_tpu_torch.parallel import dp
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render import demo as demo_mod
    from gpnerf_tpu_torch.render.base import batch_to_device, build_render
    from gpnerf_tpu_torch.train.criterion import Criterion
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model
    from gpnerf_tpu_torch.train.step import make_optimizer
    from gpnerf_tpu_torch.utils import dist

    import time

    torch.set_num_threads(2)
    t0 = time.perf_counter()
    dist.init_distributed(coordinator, world, rank)
    res = {"rank": dist.get_rank(), "world": dist.get_world_size(),
           "is_main": dist.is_main_process(), "initialized": dist.is_dist_avail_and_initialized()}
    res["reduced"] = dist.reduce_dict({"loss": 1.0 + rank, "psnr": 10.0 * (rank + 1)})
    res["summed"] = dist.reduce_dict({"n": 1.0 + rank}, average=False)
    res["gathered"] = dist.all_gather({"rank": rank, "tag": "x" * (rank + 1)})

    class _DS:
        def __len__(self):
            return 10

    res["indices"] = list(DistributedSampler(_DS(), num_replicas=world, rank=rank,
                                             shuffle=False))
    res["shuffled"] = list(DistributedSampler(_DS(), num_replicas=world, rank=rank))
    dist.barrier()

    with open(os.path.join(out_dir, "inputs.pkl"), "rb") as f:
        inp = pickle.load(f)
    cfg = small_cfg(port_cfg)
    render = build_render(cfg, device="cpu")
    render.load_state_dict(inp["state"], strict=True)
    if rank == 1:  # the step's broadcast must make this copy rank 0's again
        with torch.no_grad():
            for p in render.parameters():
                p.add_(0.5)
    opt, sched, _ = make_optimizer(render, cfg)
    render.train()
    step = dp.make_dp_train_step(render, Criterion(cfg), opt, sched)
    metrics, _ = step(batch_to_device(inp["frames"][rank], "cpu"),
                      t_rand=torch.from_numpy(inp["t_rand"][rank]))
    res["metrics"] = {k: float(v) for k, v in metrics.items()}
    out = {"grads": {k: p.grad.clone() for k, p in render.named_parameters()},
           "state": {k: v.clone() for k, v in render.state_dict().items()}}

    # the ray-sharded eval render against the unsharded one
    render.eval()
    eb = batch_to_device(inp["eval_frame"], "cpu")
    whole = render.render_eval(eb)
    split = dp.make_dp_eval_render(render)(eb)
    res["t_step"] = time.perf_counter() - t0
    res["eval"] = {k: float((whole[k] - split[k]).abs().max()) for k in whole}
    res["eval_shapes"] = {k: [list(whole[k].shape), list(split[k].shape)] for k in whole}

    res["t_eval"] = time.perf_counter() - t0
    # the progressive render: 2 ranks against one
    demo = get("render", "demo_render")(small_cfg(port_cfg, **DEMO), device="cpu")
    load_eval_model(CKPT, demo)
    db = batch_to_device(inp["demo_frame"], "cpu")
    single = demo.render_demo_fn()(db)
    multi = dp.make_dp_demo_render(demo)(db)
    res["demo"] = {
        "same": {k: bool(torch.equal(single[k], multi[k]))
                 for k in ("ray_ok", "ray_pix_idx", "mask_at_box", "overflows", "counts")},
        "pred_max": float((single["pred_chw"] - multi["pred_chw"]).abs().max()),
        "rgb_max": float((single["rgb_map"] - multi["rgb_map"]).abs().max()),
        "counts": single["counts"].tolist(), "overflows": single["overflows"].tolist(),
    }
    stub = _StubDemo()
    stub._assemble = lambda *a: demo_mod.Renderer._assemble(stub, *a)
    ov = dp.make_dp_demo_render(stub)({"src_imgs": torch.zeros(3, 4, 4, 3),
                                       "tar_img": torch.zeros(8, 8, 3)})
    res["stub"] = {"overflows": ov["overflows"].tolist(), "counts": ov["counts"].tolist()}

    res["seconds"] = time.perf_counter() - t0
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.shutdown()


# --------------------------------------------------------------------------
# the tests
# --------------------------------------------------------------------------


@pytest.mark.parametrize("n,replicas,shuffle", [(10, 2, False), (10, 3, True), (7, 4, True),
                                                (1, 2, False), (60, 8, True)])
def test_distributed_sampler_matches_jax(n, replicas, shuffle):
    from gpnerf_tpu.data.loader import DistributedSampler as JaxSampler
    from gpnerf_tpu_torch.data.loader import DistributedSampler

    ds = list(range(n))
    seen = []
    for rank in range(replicas):
        for epoch in (0, 3):
            p = DistributedSampler(ds, replicas, rank, shuffle=shuffle)
            j = JaxSampler(ds, replicas, rank, shuffle=shuffle)
            p.set_epoch(epoch)
            j.set_epoch(epoch)
            assert list(p) == list(j) and len(p) == len(j)
            if epoch == 0:
                seen += list(p)
    assert sorted(set(seen)) == ds and len(seen) == replicas * -(-n // replicas)


def test_distributed_sampler_hypothesis():
    from hypothesis import given, settings
    from hypothesis import strategies as st

    from gpnerf_tpu.data.loader import DistributedSampler as JaxSampler
    from gpnerf_tpu_torch.data.loader import DistributedSampler

    @settings(max_examples=60, deadline=None)
    @given(st.integers(1, 64), st.integers(1, 8), st.data(), st.integers(0, 50), st.booleans())
    def check(n, replicas, data, epoch, shuffle):
        rank = data.draw(st.integers(0, replicas - 1))
        p = DistributedSampler(range(n), replicas, rank, shuffle=shuffle)
        j = JaxSampler(range(n), replicas, rank, shuffle=shuffle)
        p.set_epoch(epoch)
        j.set_epoch(epoch)
        assert drawn(p) == drawn(j)

    def drawn(sampler):
        # wrap-around padding of fewer items than the shortfall fails the
        # size assertion in both packages (e.g. 1 item over 3 replicas)
        try:
            return list(sampler)
        except AssertionError:
            return "short"

    check()


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's 2-device step and mean gradient, then the two port ranks."""
    import random

    import jax
    import jax.numpy as jnp

    from gpnerf_tpu.config import cfg as jax_cfg
    from gpnerf_tpu.parallel.dp import make_dp_train_step, make_mesh, stack_batches
    from gpnerf_tpu.registry import get as jax_get
    from gpnerf_tpu.train.step import make_optimizer, merge_variables, split_variables
    from gpnerf_tpu_torch.train.checkpoint import from_jax_variables

    tmp = tmp_path_factory.mktemp("dp")
    cfg = small_cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    ds = jax_get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    frames = [ds[0], ds[1]]
    render = jax_get("render", cfg.render.file)(cfg)
    crit = jax_get("criterion", cfg.train.criterion_file)(cfg)
    jb = {k: jnp.asarray(v) for k, v in frames[0].items()}
    variables = jax.tree.map(np.asarray, jax.jit(render._init_variables_impl)(jax.random.PRNGKey(0), jb))
    params, bstats = split_variables(variables)
    rngs = jax.random.split(jax.random.PRNGKey(1), WORLD)
    t_rand = [np.asarray(jax.random.uniform(rngs[i], (cfg.train.n_rays, cfg.train.n_samples)))
              for i in range(WORLD)]

    # the two port ranks run while JAX compiles its side
    dcfg = small_cfg(jax_cfg, **DEMO)
    random.seed(1)  # the bench protocol's seed of its second frame
    np.random.seed(1)
    demo_frame = jax_get("dataset", dcfg.dataset.test.file)(dcfg, is_train=False)[DEMO_ITEM]
    np.random.seed(0)
    random.seed(0)
    eval_frame = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"state": from_jax_variables(variables), "frames": frames,
                     "t_rand": t_rand, "eval_frame": eval_frame, "demo_frame": demo_frame}, f)
    coordinator = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, PYTHONPATH=ROOT)
    logs = [open(tmp / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), str(tmp), coordinator,
                               str(WORLD), str(r)], cwd=ROOT, env=env, stdout=logs[r],
                              stderr=subprocess.STDOUT) for r in range(WORLD)]
    try:
        def loss_fn(p, batch, rng):
            ret, _ = render.render_train(merge_variables(p, bstats), batch, rng)
            return sum(crit(ret, batch, True).values())

        # the gradient reference of tests/test_torch_train_step.py: JAX's
        # loss with its BatchNorm and InstanceNorm statistics in float64
        import gpnerf_tpu.models.encoder as jax_encoder
        import gpnerf_tpu.models.sparse_net as jax_sparse_net
        from test_torch_train_step import F64StatsBN, F64StatsIN

        saved = jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm
        jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm = F64StatsBN, F64StatsIN
        try:
            with jax.enable_x64(True):
                gfun = jax.jit(jax.grad(loss_fn))
                grads = [gfun(params, {k: jnp.asarray(v) for k, v in f.items()}, rngs[i])
                         for i, f in enumerate(frames)]
                gmean = jax.tree.map(lambda a, b: np.asarray((a + b) / 2), *grads)
        finally:
            jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm = saved

        optimizer, _ = make_optimizer(cfg)
        step = make_dp_train_step(render, crit, optimizer, make_mesh(WORLD))
        batches = {k: jnp.asarray(v) for k, v in stack_batches(frames).items()}
        new_p, new_bs, _, metrics = step(params, bstats, optimizer.init(params), batches, rngs)
        for p in procs:
            p.wait(timeout=300)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    errs = [(tmp / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD)]
    assert all(p.returncode == 0 for p in procs), errs
    ranks = []
    for r in range(WORLD):
        with open(tmp / f"rank{r}.json") as f:
            res = json.load(f)
        res.update(torch.load(tmp / f"rank{r}.pt", weights_only=False))
        ranks.append(res)
    return {
        "cfg": cfg, "ranks": ranks, "before": from_jax_variables(variables),
        "jax_grads": from_jax_variables({k: v for k, v in gmean.items()}),
        "jax_after": from_jax_variables(jax.tree.map(np.asarray,
                                                     merge_variables(new_p, new_bs))),
        "jax_metrics": {k: float(v) for k, v in jax.tree.map(np.asarray, metrics).items()},
    }


def test_control_plane(runs):
    """Rank gating, reduce_dict (mean and sum), all_gather in rank order,
    and the sampler's disjoint contiguous shards covering the set."""
    results = runs["ranks"]
    for r, res in enumerate(results):
        assert res["rank"] == r and res["world"] == WORLD and res["initialized"]
        assert res["is_main"] == (r == 0)
        assert abs(res["reduced"]["loss"] - 1.5) < 1e-6
        assert abs(res["reduced"]["psnr"] - 15.0) < 1e-6
        assert res["summed"] == {"n": 3.0}
        assert [g["rank"] for g in res["gathered"]] == [0, 1]
        assert [g["tag"] for g in res["gathered"]] == ["x", "xx"]
    idx0, idx1 = results[0]["indices"], results[1]["indices"]
    assert idx0 == [0, 1, 2, 3, 4] and idx1 == [5, 6, 7, 8, 9]
    assert sorted(results[0]["shuffled"] + results[1]["shuffled"]) == list(range(10))


def test_dp_ranks_stay_replicas(runs):
    """After the step both ranks hold the same parameters and running
    statistics, bit for bit (rank 1's perturbed copy was replaced)."""
    a, b = (r["state"] for r in runs["ranks"])
    assert set(a) == set(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    ga, gb = (r["grads"] for r in runs["ranks"])
    for k in ga:
        assert torch.equal(ga[k], gb[k]), k


def test_dp_gradients_match_jax(runs):
    """The averaged gradients against JAX's mean of the two frames'
    gradients (its loss with float64 norm statistics, as
    tests/test_torch_train_step.py takes it), key by key, scale-aware
    (tests/test_parallel.py:68)."""
    ref = runs["jax_grads"]
    grads = runs["ranks"][0]["grads"]
    assert set(grads) == set(ref)
    global_scale = max(float(g.abs().max()) for g in ref.values())
    for k, g in grads.items():
        a, b = ref[k].numpy(), g.numpy()
        scale = max(np.abs(a).max(), 1e-4 * global_scale)
        assert np.abs(a - b).max() <= 5e-2 * scale + 1e-9, k


def test_dp_batchnorm_stats_and_metrics_match_jax(runs):
    """The averaged running statistics within 1e-6 of JAX's pmean, moved;
    the averaged metrics as JAX's (loss within 1e-5 relative)."""
    state, ref, before = runs["ranks"][0]["state"], runs["jax_after"], runs["before"]
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 14
    for k in keys:
        np.testing.assert_allclose(state[k].numpy(), ref[k].numpy(), atol=1e-6, err_msg=k)
        assert not torch.equal(state[k], before[k]), k
    pm, jm = runs["ranks"][0]["metrics"], runs["jax_metrics"]
    assert set(pm) == set(jm)
    for k in pm:
        assert abs(pm[k] - jm[k]) <= 1e-5 * max(abs(jm[k]), 1e-12), (k, pm[k], jm[k])
    assert pm == runs["ranks"][1]["metrics"]


def test_dp_parameters_after_adamw_match_jax(runs):
    """The parameters after AdamW against JAX's DP step, with
    tests/test_torch_train_step.py's tolerance; where the directions are
    opposite on a parameter near 1 (a norm scale) the float32 results lie 2
    lr apart to within their rounding, which that test's values did not
    reach."""
    cfg, before, after = runs["cfg"], runs["before"], runs["jax_after"]
    lr, wd = cfg.train.lr, cfg.train.weight_decay
    state = runs["ranks"][0]["state"]
    n_all = n_over = 0
    for k, g in runs["ranks"][0]["grads"].items():
        p0, pp, pj = before[k].double(), state[k].double(), after[k].double()
        sp = -(pp - p0) / lr - wd * p0
        sj = -(pj - p0) / lr - wd * p0
        special = (torch.sign(sp) != torch.sign(sj)) | (sp.abs() < 0.99) | (sj.abs() < 0.99)
        over = (pp - pj).abs() > 1e-6
        assert bool(special[over].all()), k
        # 2 lr apart when the directions are opposite, plus the float32
        # rounding of both results (one ulp of |p| each)
        ulp = float(np.finfo(np.float32).eps) * float(pj.abs().max())
        assert float((pp - pj).abs().max()) <= 2 * lr + 2 * ulp, k
        n_all += pp.numel()
        n_over += int(over.sum())
    print(f"elements beyond 1e-6 (within 2 lr): {n_over} of {n_all}")
    assert n_over <= 5e-3 * n_all, (n_over, n_all)


def test_dp_demo_render_matches_single_process(runs):
    """Integers bitwise, colors within 1e-4 (tests/test_parallel.py:178), on
    both ranks; the frame renders rays and colored points."""
    for res in runs["ranks"]:
        d = res["demo"]
        assert all(d["same"].values()), d["same"]
        assert d["pred_max"] <= 1e-4 and d["rgb_max"] <= 1e-4, d
        assert d["counts"][0] > 0 and d["counts"][2] > 0, d
        assert d["overflows"][0] == 0, d


def test_dp_demo_overflow_aggregation(runs):
    """ray_overflow from the local frame stage; the slices' per-ray and
    sigma overflows summed, never divided by the ranks
    (tests/test_parallel.py:125): slice i's near holds 8i .. 8i + 7."""
    for res in runs["ranks"]:
        ov = res["stub"]["overflows"]
        assert ov[0] == 3 and ov[3] == 0
        assert ov[1] == sum(range(16))
        assert ov[2] == 7 + 15
        assert res["stub"]["counts"] == [16, 16, 2]


def test_dp_eval_render_matches_unsharded(runs):
    """Every output of the ray-split eval render equals the unsharded
    render's, at the ray cap's shape."""
    for res in runs["ranks"]:
        for k, (a, b) in res["eval_shapes"].items():
            assert a == b and a[0] == runs["cfg"].tpu.eval_ray_cap, k
        assert max(res["eval"].values()) <= 1e-6, res["eval"]


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    _worker(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]))
