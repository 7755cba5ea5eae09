"""The port's Trainer end to end on the CPU at the size of
tests/test_bf16_train.py (tiny encoder, 128^2, code_dim 16, 256 rays x 8
samples): two epochs of two steps with quick_val, the checkpoint files, a
resume that restores the epoch and the optimizer, evaluation through the
training renderer and through the progressive renderer; a port-written
checkpoint loaded strictly by the JAX package; the whole-image eval render
against the JAX package's `render_eval_fn`; the train CLI; and every
out-of-scope switch raising with its key named."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load_eval_model
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.data.loader import DataLoader, build_batchsampler
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import batch_to_device, build_render, check_train_scope
from gpnerf_tpu_torch.train.checkpoint import from_jax_variables, load_checkpoint
from gpnerf_tpu_torch.train.criterion import Criterion
from gpnerf_tpu_torch.train.step import make_optimizer
from gpnerf_tpu_torch.train.trainer import Trainer
from gpnerf_tpu_torch.utils.logging_utils import create_logger
from test_dataset_fixtures import thuman_root  # noqa: F401  (a fixture)

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = {
    "encoder.name": "tiny", "dataset.H": 128, "dataset.W": 128, "head.sigma.code_dim": 16,
    "train.n_rays": 256, "train.n_samples": 8, "tpu.eval_ray_cap": 4096, "tpu.eval_chunk": 1024,
}


def small_cfg(base, **extra):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.merge_from_list([x for kv in {**SMALL, **extra}.items() for x in kv])
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two Trainer epochs of two steps each, quick_val every second step."""
    tmp = tmp_path_factory.mktemp("train")
    cfg = small_cfg(port_cfg, **{
        "train.ep_iter": 2, "train.max_epoch": 3, "train.valiter_interval": 2,
        "train.print_freq": 1, "log_dir": str(tmp / "logs") + "/",
        "result_dir": str(tmp / "results"), "output_dir": "synthtest/",
    })
    random.seed(0)
    np.random.seed(0)
    train_ds = port_get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    eval_ds = port_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    train_loader = DataLoader(train_ds, build_batchsampler(cfg, train_ds, 1, True, seed=0))
    eval_loader = DataLoader(eval_ds, [[0], [6]])
    render = build_render(cfg, device="cpu").init_variables(0)
    initial = {k: v.clone() for k, v in render.state_dict().items()}
    opt, sched, schedule = make_optimizer(render, cfg)
    logger, _ = create_logger(cfg, rank=0, phase="test")
    trainer = Trainer(cfg, render=render, criterion=Criterion(cfg), optimizer=opt,
                      scheduler=sched, lr_schedule=schedule, logger=logger, log_dir=cfg.log_dir)
    trainer.train(train_loader, eval_loader)
    trainer.train(train_loader, eval_loader)
    save_dir = os.path.join(cfg.log_dir, cfg.output_dir, cfg.output_dir)
    return {"cfg": cfg, "trainer": trainer, "initial": initial, "save_dir": save_dir,
            "eval_loader": eval_loader, "tmp": tmp}


def test_two_epochs_checkpoints_and_quick_val(trained):
    """Epoch 0 writes no checkpoint, epoch 1 writes 1.pth in the reference
    layout and model_best.pth; parameters and BN statistics moved; the
    events file carries the quick-val scalars."""
    tr, cfg = trained["trainer"], trained["cfg"]
    assert tr.epoch == 2 and tr.iter_count == 4
    files = os.listdir(trained["save_dir"])
    assert "1.pth" in files and "0.pth" not in files and "model_best.pth" in files
    ckpt = torch.load(os.path.join(trained["save_dir"], "1.pth"), weights_only=False)
    assert set(ckpt) == {"epoch", "model", "performance/psnr", "state_dict", "optimizer"}
    assert ckpt["epoch"] == 1 and ckpt["model"] == "BaseRender"
    assert np.isfinite(ckpt["performance/psnr"]) and tr.best_performance == ckpt["performance/psnr"]
    state = tr.render.state_dict()
    assert set(ckpt["state_dict"]) == set(state)
    moved = [k for k in state if not torch.equal(state[k], trained["initial"][k])]
    assert any(k.endswith("running_mean") for k in moved) and any("encoder" in k for k in moved)
    assert all(int(state[k]) == 4 for k in state if k.endswith("num_batches_tracked"))
    with open(os.path.join(cfg.log_dir, cfg.output_dir, "events.jsonl")) as f:
        text = f.read()
    assert '"tag": "eval_psnr"' in text and '"tag": "train_loss"' in text
    assert tr.scheduler.last_epoch == 4 and tr.optimizer.param_groups[0]["lr"] == tr.lr_schedule(4)


def test_checkpoint_loads_strictly_into_jax(trained):
    """The JAX package's strict `load_eval_model` takes the port's
    checkpoint and gives back every tensor bitwise."""
    cfg_j = small_cfg(jax_cfg)
    random.seed(0)
    np.random.seed(0)
    b = jax_get("dataset", cfg_j.dataset.train.file)(cfg_j, is_train=True)[0]
    jr = jax_get("render", "BaseRender")(cfg_j)
    shapes = jax.eval_shape(lambda k: jr._init_variables_impl(k, b), jax.random.PRNGKey(0))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    loaded = jax_load_eval_model(os.path.join(trained["save_dir"], "1.pth"), template, 4)
    back = from_jax_variables(jax.tree.map(np.asarray, loaded))
    state = trained["trainer"].render.state_dict()
    for k, v in back.items():
        if not k.endswith("num_batches_tracked"):
            assert torch.equal(v, state[k]), k


def test_resume_restores_epoch_and_optimizer(trained):
    cfg = trained["cfg"].clone()
    cfg.defrost()
    cfg.render.resume_path = os.path.join(trained["save_dir"], "1.pth")
    cfg.train.resume = True
    cfg.freeze()
    render = build_render(cfg, device="cpu").init_variables(7)
    opt, _, _ = make_optimizer(render, cfg)
    assert load_checkpoint(cfg, render, opt) == 1
    ref = trained["trainer"]
    for (k, p), q in zip(render.named_parameters(), ref.render.parameters()):
        assert torch.equal(p, q), k
        st, st_ref = opt.state[p], ref.optimizer.state[q]
        assert int(st["step"]) == int(st_ref["step"]) == 4
        assert torch.equal(st["exp_avg"], st_ref["exp_avg"]) and torch.equal(
            st["exp_avg_sq"], st_ref["exp_avg_sq"]), k
    resumed = Trainer(cfg, render=render, criterion=Criterion(cfg), optimizer=opt,
                      last_iter=1, logger=None)
    assert resumed.epoch == 2
    cfg.defrost()
    cfg.render.resume_path = os.path.join(trained["save_dir"], "missing.pth")
    with pytest.raises(FileNotFoundError):
        load_checkpoint(cfg, render, opt)


def test_evaluate_through_both_renderers(trained):
    """`evaluate` through the training renderer and, with the trained
    state dict loaded strictly, through the progressive renderer (its
    point stages' plain version on the CPU): finite metrics, images and
    overflow rows."""
    tr, cfg = trained["trainer"], trained["cfg"]
    out = trained["tmp"] / "eval"
    m_base, t_base = tr.evaluate(trained["eval_loader"], str(out), is_vis=True)
    assert np.isfinite(m_base["psnr"]) and 0 <= m_base["ssim"] <= 1 and t_base > 0
    assert {"0.jpg", "1.jpg"} <= set(os.listdir(out))
    cfg_d = cfg.clone()
    cfg_d.defrost()
    cfg_d.render.file = "demo_render"
    cfg_d.tpu.ray_cap = 16384
    cfg_d.freeze()
    demo = port_get("render", cfg_d.render.file)(cfg_d, device="cpu")
    demo.load_state_dict(tr.render.state_dict(), strict=True)
    m_demo, t_demo = Trainer(cfg_d, render=demo).evaluate(trained["eval_loader"], str(out))
    assert np.isfinite(m_demo["psnr"]) and 0 <= m_demo["ssim"] <= 1 and t_demo > 0
    assert m_demo["overflows_max"][0] == 0


def test_render_eval_matches_jax():
    """The whole-image eval render (4 chunks of 1024 padded box rays) from
    the same JAX-initialized variables: every output within 1e-4 (rgb) /
    1e-3 relative (depth) of JAX's `render_eval_fn`, over the valid rays."""
    cfg_j, cfg_p = small_cfg(jax_cfg), small_cfg(port_cfg)
    random.seed(0)
    np.random.seed(0)
    b = jax_get("dataset", cfg_j.dataset.test.file)(cfg_j, is_train=False)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jr = jax_get("render", "BaseRender")(cfg_j)
    variables = jax.jit(jr._init_variables_impl)(jax.random.PRNGKey(0), jb)
    jout = jax.tree.map(np.asarray, jr.render_eval_fn()(variables, jb))
    port = build_render(cfg_p, device="cpu")
    port.load_state_dict(from_jax_variables(jax.tree.map(np.asarray, variables)), strict=True)
    pout = port.render_eval_fn()(batch_to_device(b, "cpu"))
    assert set(pout) == set(jout)
    n = int(b["n_rays"])
    assert 0 < n <= b["ray_o"].shape[0] == pout["rgb_map"].shape[0]
    for k in ("rgb_map", "acc_map", "rgb_in_map"):
        np.testing.assert_allclose(pout[k].numpy()[:n], jout[k][:n], atol=1e-4, err_msg=k)
    np.testing.assert_allclose(pout["depth_map"].numpy()[:n], jout["depth_map"][:n], rtol=1e-3,
                               atol=1e-4)
    assert float(pout["acc_map"][:n].max()) > 0.05
    cfg_bad = small_cfg(port_cfg, **{"tpu.eval_chunk": 1000})
    with pytest.raises(ValueError, match="eval_chunk"):
        build_render(cfg_bad, device="cpu").render_eval(batch_to_device(b, "cpu"))


@pytest.mark.parametrize("key,value,match", [
    ("tpu.train_dtype", "bfloat16", "tpu.train_dtype"),
    ("head.rgb.use_rgbhead", False, "head.rgb.use_rgbhead"),
    ("tpu.dp_size", 2, "tpu.dp_size"),
    # neg-ray (THuman) data, refused before the neg-ray slice: now in scope,
    # it sets the renderer's flag of its split (tests/test_torch_negray.py
    # holds the renders against JAX)
    pytest.param("dataset.train.name", "thuman", None,
                 id="dataset.train.name-thuman-dataset.train.name"),
    pytest.param("dataset.test.name", "thuman-synthetic", None,
                 id="dataset.test.name-thuman-synthetic-dataset.test.name"),
])
def test_out_of_scope_switches_raise(key, value, match):
    cfg = small_cfg(port_cfg, **{key: value})
    if key == "tpu.train_dtype":
        # bf16 training, refused before the bf16 slice: now in scope
        # (tests/test_torch_bf16_train.py holds it against JAX); the
        # encoder's and the heads' layers compute in bf16 on real bf16
        # tensors, the BatchNorms and the parameters stay float32
        from gpnerf_tpu_torch.models.layers import MLP, ReflectConv
        from gpnerf_tpu_torch.models.sparse_net import SparseConvNet

        check_train_scope(cfg)
        r = build_render(cfg, device="cpu")
        layers = [m for m in r.modules() if isinstance(m, (ReflectConv, MLP, SparseConvNet))]
        assert len(layers) > 20
        assert all(m.compute_dtype == torch.bfloat16 and m.native for m in layers)
        assert all(p.dtype == torch.float32 for p in r.parameters())
        return
    if key == "head.rgb.use_rgbhead":
        # the mesh branch, refused before the mesh slice: now in scope
        # (tests/test_torch_mesh.py holds render_mesh against JAX)
        check_train_scope(cfg)
        assert build_render(cfg, device="cpu").mesh_th == 1.0 / cfg.test.mesh_th
        return
    if key == "tpu.dp_size":
        # data parallelism, refused before the data-parallel slice: now in
        # scope (tests/test_torch_dp.py holds the 2-rank step against JAX's
        # 2-device step). The width clamps to the ranks; a group of some
        # ranks only, or several frames per step over ranks, still raise
        from gpnerf_tpu_torch.render.base import resolved_dp

        check_train_scope(cfg)
        build_render(cfg, device="cpu")
        assert (resolved_dp(cfg, 1), resolved_dp(cfg, 2), resolved_dp(cfg, 8)) == (1, 2, 2)
        with pytest.raises(NotImplementedError, match=match):
            check_train_scope(cfg, world=4)
        two = small_cfg(port_cfg, **{"dataset.img_num_per_gpu": 2})
        check_train_scope(two, world=1)
        with pytest.raises(NotImplementedError, match="dataset.img_num_per_gpu"):
            check_train_scope(two, world=2)
        return
    if match is None:
        check_train_scope(cfg)
        r = build_render(cfg, device="cpu")
        assert (r.neg_ray_train, r.neg_ray_val) == (key == "dataset.train.name",
                                                   key == "dataset.test.name")
        return
    with pytest.raises(NotImplementedError, match=match):
        check_train_scope(cfg)
    with pytest.raises(NotImplementedError, match=match):
        build_render(cfg, device="cpu")


def test_train_cli(tmp_path, monkeypatch):
    """tools/train_torch.py: without a CUDA device and without `device cpu`
    it raises; with `device cpu` it trains one epoch of two steps, writes
    its logs and exits when max_epoch is reached."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "tools", "train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    yaml = os.path.join(ROOT, "configs", "synthetic.yaml")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cpu"):
        cli.select_device([])
    with pytest.raises(RuntimeError, match="device cpu"):
        cli.select_device(["train.lr", "0.001"])
    assert cli.select_device(["device", "cpu"]).type == "cpu"
    monkeypatch.chdir(tmp_path)
    small = [str(x) for kv in SMALL.items() for x in kv]
    with pytest.raises(SystemExit) as done:
        cli.main(["--cfg", yaml, "device", "cpu", *small, "train.ep_iter", "2",
                  "train.max_epoch", "0", "train.val_when_train", "False", "workers", "0"])
    assert done.value.code == 0
    assert os.path.isdir(tmp_path / "work_dirs") and os.path.isdir(tmp_path / "logs")


def test_train_cli_thuman_with_zju_val(tmp_path, monkeypatch, capsys, thuman_root,  # noqa: F811
                                       zju_root):
    """tools/train_torch.py on configs/trainthu_valzju.yaml, the paper's
    cross-dataset config: neg-ray training on the fabricated THuman tree,
    quick_val on the fabricated ZJU-MoCap tree, both through the registry's
    datasets, at the small size (ratio 0.125: THuman 256 -> 32, ZJU 1024 ->
    128). Two steps, one quick_val, exit 0."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "train_torch", os.path.join(ROOT, "tools", "train_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    monkeypatch.chdir(tmp_path)
    small = [str(x) for k, v in SMALL.items() if not k.startswith("dataset.") for x in (k, v)]
    with pytest.raises(SystemExit) as done:
        cli.main(["--cfg", os.path.join(ROOT, "configs", "trainthu_valzju.yaml"), "device", "cpu",
                  *small, "dataset.ratio", "0.125", "dataset.train.data_root", thuman_root,
                  "dataset.test.data_root", zju_root, "dataset.test.seq_list", "['CoreView_387']",
                  "train.ep_iter", "2", "train.max_epoch", "0", "train.valiter_interval", "2",
                  "workers", "0"])
    assert done.value.code == 0
    logged = "".join(capsys.readouterr())
    assert "rgb_loss:" in logged and "psnr:" in logged  # the quick_val line
