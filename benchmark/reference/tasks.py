"""What the reference computes for a run once its window has closed: the
renders of the checked requests, and the first steps of training, each
from the benchmark's raw inputs and the configuration's weights.

GP-NeRF's reference module, which a configuration without a `reference`
key names (benchmark/system.py). A reference module of another
architecture has `render_items`, `train_readings` and `train_sites` as
here."""

from __future__ import annotations

import torch

from benchmark import pool
from benchmark.check import leaf_norms
from benchmark.reference import build
from benchmark.reference.eager.data.base import HumanNVSDataset
from benchmark.reference.eager.render.base import batch_to_device
from benchmark.reference.eager.train.criterion import Criterion

ADAM_BETAS = (0.9, 0.999)
ADAM_EPS = 1e-8


def render_outputs(ret, batch):
    """What a request's answer is judged by: the image, the pixels that got
    a ray, the counts (rays, kept slots, colored points) and overflows;
    with the active sites per sparse level of the frame's batch."""
    return {
        "image": ret["pred_chw"].float().permute(1, 2, 0).cpu().numpy(),
        "mask": ret["mask_at_box"].cpu().numpy().astype(bool),
        "counts": [int(v) for v in ret["counts"].tolist()],
        "overflows": [int(v) for v in ret["overflows"].tolist()],
        "sites": [int(batch[f"lvl{i}_valid"].sum()) for i in range(5)],
    }


def render_items(conf, scene, poses, cams, seed, items, device, control=False):
    """{item: render_outputs} of the reference (or its control) on the
    requests `items` of the pool (poses, cams)."""
    cfg = conf["cfg"]
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "test", cfg)
    model = build.load_weights(build.demo_renderer(cfg, device), conf["weights"])
    if control:
        build.fp8_control(model)
    out = {}
    with build.tf32(False), torch.no_grad():
        for i in items:
            hb = pool.build_batches(ds, seed, [i], pool.VIEW_TAG)[0]
            out[i] = render_outputs(model.render_demo(batch_to_device(hb, device)), hb)
    del model
    return out


def train_readings(conf, scene, poses, cams, seed, t_rands, device, control=False):
    """The reference's first len(t_rands) optimizer steps from the
    configuration's weights on the train batches 0, 1, ...: each step's
    loss, each leaf's first gradient norm, each leaf's change norm."""
    cfg = conf["cfg"]
    t = cfg["train"]
    steps = len(t_rands)
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "train", cfg)
    batches = [batch_to_device(b, device)
               for b in pool.build_batches(ds, seed, range(steps), pool.TRAIN_TAG)]
    model = build.load_weights(build.train_renderer(cfg, device), conf["weights"])
    params = dict(model.named_parameters())
    start = {n: p.detach().clone() for n, p in params.items()}
    opt = torch.optim.AdamW(model.parameters(), lr=t["lr"], betas=ADAM_BETAS, eps=ADAM_EPS,
                            weight_decay=t["weight_decay"])

    def lr_at(k):  # gpnerf_tpu_torch/train/lr.py exponential_epoch_schedule
        return t["gamma"] ** ((k // t["ep_iter"]) / t["decay_epochs"])

    sched = torch.optim.lr_scheduler.LambdaLR(opt, lr_at)
    crit = Criterion(None)
    losses, grad1 = [], None
    with build.tf32(control):
        for k in range(steps):
            opt.zero_grad()
            ret = model.render_train(batches[k], t_rand=t_rands[k])
            loss = crit(ret, batches[k])["rgb_loss"]
            loss.backward()
            for p in params.values():
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            opt.step()
            sched.step()
            losses.append(loss.item())
            if k == 0:
                grad1 = {n: float((opt.state[p]["exp_avg"] / (1 - ADAM_BETAS[0])).double().norm())
                         for n, p in params.items()}
    change = leaf_norms((n, p - start[n]) for n, p in params.items())
    del model, opt
    return {"losses": losses, "grad1": grad1, "change": change}


def train_sites(conf, scene, poses, cams, seed, n):
    """The active sites per sparse level of train batches 0..n-1, from the
    reference's data layer."""
    ds = pool.make_dataset(HumanNVSDataset, scene, poses, cams, "train", conf["cfg"])
    return [[int(b[f"lvl{i}_valid"].sum()) for i in range(5)]
            for b in pool.build_batches(ds, seed, range(n), pool.TRAIN_TAG)]
