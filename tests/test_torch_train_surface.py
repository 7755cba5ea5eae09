"""The port's train and eval surface beside bf16 training: several frames
per step (`dataset.img_num_per_gpu` > 1), the `image_size` batch sampler,
train/evaluator_variant.py and tools/train_bench_torch.py, at the size of
tests/test_torch_train_step.py (tiny encoder, 128^2, code_dim 16, 256 rays
x 8 samples).

  * A 2-frame `Trainer.train` epoch equals two 1-frame epochs on the same
    frames bit for bit on the CPU: parameters, iter_count, lr.
  * The step count, the lr sequence and the quick-val cadence over a mix
    of list and single-frame batches follow the JAX Trainer's rule for a
    list on one device (gpnerf_tpu/train/trainer.py:142-161), run with its
    step and quick_val stubbed (nothing of it is compiled).
  * quick_val and evaluate raise on a batch of several frames, naming
    `dataset.img_num_per_gpu`.
  * The `image_size` sampler gives the JAX package's batches under the
    same seeds; an unknown sampler name raises ValueError in both.
  * evaluator_variant gives the JAX package's metrics within 1e-6 and the
    same metrics.npy.
  * tools/train_bench_torch.py --iters 3 with `device cpu` prints every
    key with finite losses; without a card and without `device cpu` it
    raises."""

import importlib.util
import json
import logging
import os
import random

import jax
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.data import loader as jloader
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.evaluator_variant import Evaluator as JaxVariant
from gpnerf_tpu.train.step import make_optimizer as jax_make_optimizer
from gpnerf_tpu.train.trainer import Trainer as JaxTrainer
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.data import loader as ploader
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.base import build_render
from gpnerf_tpu_torch.train import trainer as ptrainer
from gpnerf_tpu_torch.train.criterion import Criterion
from gpnerf_tpu_torch.train.evaluator_variant import Evaluator
from gpnerf_tpu_torch.train.step import make_optimizer

ROOT = os.path.join(os.path.dirname(__file__), "..")
SMALL = {"encoder.name": "tiny", "dataset.H": 128, "dataset.W": 128, "head.sigma.code_dim": 16,
         "train.n_rays": 256, "train.n_samples": 8, "tpu.eval_ray_cap": 4096,
         "tpu.eval_chunk": 1024}


def small_cfg(base, **over):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    for k, v in {**SMALL, **over}.items():
        node = cfg
        *path, leaf = k.split(".")
        for p in path:
            node = getattr(node, p)
        setattr(node, leaf, v)
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames():
    """Seven train frames of the synthetic split, made once."""
    cfg = small_cfg(port_cfg)
    random.seed(0)
    np.random.seed(0)
    ds = port_get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    return [ds[i] for i in range(7)]


def _trainer(cfg, seed=0):
    render = build_render(cfg, device="cpu")
    torch.manual_seed(seed)
    render.init_variables(seed)
    opt, sched, schedule = make_optimizer(render, cfg)
    return ptrainer.Trainer(cfg, render=render, criterion=Criterion(cfg), optimizer=opt,
                            scheduler=sched, lr_schedule=schedule,
                            logger=logging.getLogger("train_surface"))


def test_two_frame_epoch_equals_two_one_frame_epochs(frames):
    """One epoch of one [f0, f1] batch against an epoch of [f0] then an
    epoch of [f1]: each frame is its own AdamW step in the list's order."""
    cfg = small_cfg(port_cfg, **{"train.val_when_train": False, "train.save_interval": 1000,
                                 "train.print_freq": 1, "dataset.img_num_per_gpu": 2})
    a, b = _trainer(cfg), _trainer(cfg)
    a.train([[frames[0], frames[1]]], [])
    b.train([frames[0]], [])
    b.train([frames[1]], [])
    assert a.iter_count == b.iter_count == 2
    assert a.scheduler.last_epoch == b.scheduler.last_epoch == 2
    assert a.optimizer.param_groups[0]["lr"] == b.optimizer.param_groups[0]["lr"]
    pa, pb = dict(a.render.named_parameters()), dict(b.render.named_parameters())
    assert all(torch.equal(pa[k], pb[k]) for k in pa)
    sa, sb = a.render.state_dict(), b.render.state_dict()
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    moved = _trainer(cfg).render.state_dict()
    assert sum(not torch.equal(moved[k], sa[k]) for k in sa if "weight" in k) > 20


def test_step_count_lr_and_val_cadence_follow_jax(frames, monkeypatch):
    """Batches [f0, f1], [f2], f3, [f4, f5, f6] with valiter_interval 3
    and print_freq 2: the port's Trainer and the JAX package's (its jitted
    step and quick_val replaced by recorders) take 7 steps at lr(0..6) and
    quick-validate after the same batches: where a batch ends on a
    multiple of 3 (step 3, the unwrapped [f2]), not at step 6 inside the
    last list. The lr decays every 2 steps here."""
    over = {"train.valiter_interval": 3, "train.print_freq": 2, "train.val_when_train": True,
            "train.ep_iter": 2, "train.gamma": 0.5, "train.decay_epochs": 1,
            "train.save_interval": 1000, "tpu.dp_size": 1}
    batches = [[frames[0], frames[1]], [frames[2]], frames[3], [frames[4], frames[5], frames[6]]]
    # the port: real optimizer and schedule, the step reduced to its
    # schedule step
    pc = small_cfg(port_cfg, **over)
    t = _trainer(pc)
    lrs, vals_p = [], []

    def fake_step(render, criterion, optimizer, scheduler, batch, generator=None):
        assert isinstance(batch, dict) and "ray_o" in batch
        lrs.append(optimizer.param_groups[0]["lr"])
        optimizer.step()  # no gradients: moves nothing
        scheduler.step()
        return {"loss": torch.tensor(1.0), "overflow": torch.tensor(0)}, None

    monkeypatch.setattr(ptrainer, "train_step", fake_step)
    monkeypatch.setattr(t, "quick_val", lambda it: vals_p.append(t.iter_count) or 0.0)
    t.train(batches, [])
    # the JAX package's Trainer.train with its step and quick_val recorded
    jc = small_cfg(jax_cfg, **over)
    optimizer, schedule = jax_make_optimizer(jc)
    jt = JaxTrainer(jc, jax_get("render", "BaseRender")(jc),
                    jax_get("criterion", jc.train.criterion_file)(jc), optimizer, schedule,
                    logging.getLogger("train_surface"), None,
                    variables={"encoder": {"params": {}}, "head": {"params": {}}},
                    opt_state=None, rng=jax.random.PRNGKey(0))
    assert jt.dp == 1
    steps_j, vals_j = [], []

    def jax_step(params, batch_stats, opt_state, batch, rng):
        assert "ray_o" in batch
        steps_j.append(float(schedule(len(steps_j))))
        return params, batch_stats, opt_state, {"loss": 1.0, "overflow": 0}

    jt._step = jax_step
    jt.quick_val = lambda it: vals_j.append(jt.iter_count) or 0.0
    jt.train(batches, [])
    assert t.iter_count == jt.iter_count == 7
    assert vals_p == vals_j == [3]
    np.testing.assert_allclose(lrs, steps_j, rtol=1e-6)
    assert lrs == [pc.train.lr * 0.5 ** (k // 2) for k in range(7)]


def test_eval_of_several_frames_raises(frames, tmp_path):
    cfg = small_cfg(port_cfg, **{"dataset.img_num_per_gpu": 2})
    t = ptrainer.Trainer(cfg, render=build_render(cfg, device="cpu"))
    t.criterion = Criterion(cfg)
    t.evaluator = None
    with pytest.raises(NotImplementedError, match="dataset.img_num_per_gpu"):
        t.quick_val(iter([[frames[0], frames[1]]]))
    with pytest.raises(NotImplementedError, match="dataset.img_num_per_gpu"):
        t.evaluate([[frames[0], frames[1]]], str(tmp_path))


@pytest.mark.parametrize("seed", [0, 5])
def test_image_size_sampler_matches_jax(seed):
    """The built train batch sampler under `image_size`, batches of 3,
    against JAX's for the same permutation and np.random state; the test
    split's "origin" strategy gives (-1, -1); an unknown name raises."""
    over = {"dataset.train.batch_sampler": "image_size", "dataset.test.batch_sampler": "image_size",
            "dataset.test.sampler": ""}
    cj, cp = small_cfg(jax_cfg, **over), small_cfg(port_cfg, **over)
    ds = port_get("dataset", cp.dataset.train.file)(cp, is_train=True)
    sj = jloader.build_batchsampler(cj, ds, False, 3, True)
    sj.batch_sampler.sampler.rng = np.random.default_rng(seed)
    sp = ploader.build_batchsampler(cp, ds, 3, True, seed=seed)
    np.random.seed(seed + 1)
    want = list(sj)
    np.random.seed(seed + 1)
    got = list(sp)
    assert got == want and len(got) == cp.train.ep_iter
    assert {len(b) for b in got} == {3} and len({b[0][1:] for b in got}) > 1
    test = ploader.build_batchsampler(cp, ds, 2, False)
    assert list(test) == list(jloader.build_batchsampler(cj, ds, False, 2, False))
    assert {(h, w) for b in test for _, h, w in b} == {(-1, -1)}
    # the datasets read the index of an (index, h, w) entry
    random.seed(1)
    np.random.seed(1)
    a = ds[got[0][0]]
    random.seed(1)
    np.random.seed(1)
    b = ds[got[0][0][0]]
    assert all(np.array_equal(a[k], b[k]) for k in a)
    bad = small_cfg(port_cfg, **{"dataset.train.batch_sampler": "by_size"})
    with pytest.raises(ValueError, match="by_size"):
        ploader.build_batchsampler(bad, ds, 1, True)
    with pytest.raises(ValueError, match="by_size"):
        jloader.build_batchsampler(small_cfg(jax_cfg, **{"dataset.train.batch_sampler": "by_size"}),
                                   ds, False, 1, True)


def test_evaluator_variant_matches_jax(tmp_path):
    """Two frames of seeded rows under a blob mask (the second with the
    output's own mask): mse, PSNR and SSIM within 1e-6, the same printed
    means and metrics.npy."""
    rs = np.random.RandomState(3)
    H = W = 64
    yy, xx = np.mgrid[:H, :W]
    masks = [((yy - 30) ** 2 + (xx - 28) ** 2 < 400), ((yy - 34) ** 2 / 2 + (xx - 36) ** 2 < 300)]
    out = {}
    for name, ev_cls, base in (("port", Evaluator, port_cfg), ("jax", JaxVariant, jax_cfg)):
        cfg = small_cfg(base, **{"dataset.H": 128, "dataset.W": 128, "dataset.ratio": 0.5,
                                 "result_dir": str(tmp_path / name)})
        ev = ev_cls(cfg)
        rs = np.random.RandomState(3)
        for i, m in enumerate(masks):
            n = int(m.sum())
            gt = rs.rand(n + 5, 3).astype(np.float32)
            pred = np.clip(gt + 0.05 * rs.randn(n + 5, 3), 0, 1).astype(np.float32)
            batch = {"rgb": gt, "mask_at_box": masks[0].reshape(-1), "n_rays": np.asarray(n)}
            output = {"rgb": torch.from_numpy(pred) if name == "port" else pred}
            if i == 1:
                output["mask_at_box"] = m.reshape(-1)
            ev.evaluate(output, batch)
        out[name] = (list(ev.mse), list(ev.psnr), list(ev.ssim), ev.summarize())
    for a, b in zip(out["port"][:3], out["jax"][:3]):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    assert out["port"][3].keys() == out["jax"][3].keys()
    for k in out["port"][3]:
        assert abs(out["port"][3][k] - out["jax"][3][k]) <= 1e-6 * abs(out["jax"][3][k])
    files = [np.load(tmp_path / n / "variant" / "metrics.npy") for n in ("port", "jax")]
    np.testing.assert_allclose(files[0], files[1], rtol=1e-6)
    assert len(files[0]) == 2 and out["port"][3]["psnr"] > 20


def test_train_bench_cli(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "train_bench_torch", os.path.join(ROOT, "tools", "train_bench_torch.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    small = [str(x) for kv in SMALL.items() for x in kv]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cpu"):
        cli.main(["--iters", "3", *small])
    capsys.readouterr()
    out = cli.main(["--iters", "3", *small, "device", "cpu", "tpu.train_dtype", "bfloat16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert set(line) == {"dtype", "device", "power_limit_w", "iters", "s_per_it", "first_loss",
                         "last10_mean_loss", "losses"}
    assert line["dtype"] == "bfloat16" and line["device"] == "cpu" and line["iters"] == 3
    assert len(line["losses"]) == 3 and all(np.isfinite(line["losses"]))
    assert line["first_loss"] == line["losses"][0] and line["s_per_it"] > 0
    assert line["last10_mean_loss"] == round(float(np.mean(line["losses"])), 5)
