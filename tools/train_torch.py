"""Train with the PyTorch/CUDA port (gpnerf_tpu_torch), on one device or
data parallel over several processes, one per device.

    python tools/train_torch.py --cfg configs/synthetic.yaml [key value ...]

The same `--cfg` plus dotted-override surface as tools/train.py. Training
runs on the GPU. Only `device cpu` given on the command line selects the
CPU (for small runs: e.g. `device cpu encoder.name tiny dataset.H 128
dataset.W 128 train.n_rays 256 train.n_samples 8`); a YAML file's `device`
key is the JAX package's platform choice and does not move the port off the
card. Without a CUDA device and without `device cpu` the script raises.

The datasets are the registry's: the synthetic fixture, ZJU-MoCap
(`ZjumocapDataset`) and THuman (`CustomDataset`, whose neg-ray convention
a dataset name holding "thuman" turns on), as in configs/trainzju_valzju.yaml
and configs/trainthu_valzju.yaml. `tpu.train_dtype bfloat16` trains in
bf16 mixed precision (float32 parameters, bf16 convolutions and Dense
layers; render/base.build_render); `dataset.img_num_per_gpu` > 1 loads that
many frames per batch and steps each (train/trainer.py); the
`image_size` batch sampler is data/loader.py's. A quick-val batch of
several frames raises NotImplementedError naming the key
(train/trainer.one_frame). Float32 is float32: TF32 is off for matmuls and
cuDNN convolutions.

Data parallelism (`init_multihost`): the same command started once per
rank, with the rendezvous in GPNERF_COORDINATOR (host:port) /
GPNERF_NUM_PROCESSES / GPNERF_PROCESS_ID, or torchrun's env:// variables
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or SLURM's
(SLURM_NTASKS, SLURM_PROCID, SLURM_LOCALID; the coordinator is
MASTER_ADDR:MASTER_PORT, else the first node of SLURM_STEP_NODELIST on
port 29500). Rank r trains on cuda:(local rank % the cards it sees) over
NCCL, or on the CPU over gloo under `device cpu`; each loads its own shard
of the train set (data/loader.DistributedSampler), and `tpu.dp_size`
(0: every rank) picks the data-parallel step (parallel/dp.py), one frame
per rank per step. E.g. two ranks on the CPU:

    for r in 0 1; do GPNERF_COORDINATOR=localhost:29511 GPNERF_NUM_PROCESSES=2 \
      GPNERF_PROCESS_ID=$r python tools/train_torch.py --cfg configs/synthetic.yaml \
      device cpu [small-run overrides] & done; wait
    torchrun --nproc_per_node 2 tools/train_torch.py --cfg configs/synthetic.yaml
"""

from __future__ import annotations

import argparse
import os
import random
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from gpnerf_tpu_torch.config import cfg as default_cfg, update_config  # noqa: E402


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="GP-NeRF training, PyTorch port")
    parser.add_argument("--cfg", dest="yaml_file", required=True,
                        help="experiment config file", type=str)
    parser.add_argument("opts", help="modify config via dotted key/value pairs",
                        default=None, nargs=argparse.REMAINDER)
    return parser.parse_args(argv)


def select_device(opts):
    """'cpu' when the overrides say `device cpu`; else 'cuda', which must
    exist."""
    import torch

    pairs = dict(zip(opts[0::2], opts[1::2])) if opts else {}
    if pairs.get("device") == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: run on the GPU, or pass `device cpu` to run on "
                           "the CPU")
    return torch.device("cuda")


def first_slurm_node(nodelist):
    """The first host of a SLURM node list: "gpu[07-09,12],cpu1" -> "gpu07"."""
    depth, end = 0, len(nodelist)
    for i, c in enumerate(nodelist):
        depth += (c == "[") - (c == "]")
        if c == "," and depth == 0:
            end = i
            break
    head = nodelist[:end]
    if "[" not in head:
        return head
    prefix, rest = head.split("[", 1)
    return prefix + rest.split(",")[0].split("-")[0].rstrip("]")


def init_multihost(device):
    """Join the process group named by the environment (tools/train.py:38-52:
    GPNERF_COORDINATOR / GPNERF_NUM_PROCESSES / GPNERF_PROCESS_ID; else
    torchrun's env://; else SLURM's variables) and return (rank, world,
    device): this rank's CUDA device, or `device` on the CPU. One process:
    (0, 1, device), no group."""
    from gpnerf_tpu_torch.utils import dist

    env = os.environ
    coord, world, rank, local = None, 1, 0, None
    if env.get("GPNERF_COORDINATOR") and env.get("GPNERF_NUM_PROCESSES"):
        coord, world = env["GPNERF_COORDINATOR"], int(env["GPNERF_NUM_PROCESSES"])
        rank = int(env.get("GPNERF_PROCESS_ID", 0))
    elif env.get("WORLD_SIZE", "1") not in ("", "1") and env.get("MASTER_ADDR"):
        coord, world, rank = "env://", int(env["WORLD_SIZE"]), int(env["RANK"])
        local = int(env.get("LOCAL_RANK", rank))
    elif env.get("SLURM_NTASKS", "1") not in ("", "1"):
        host = env.get("MASTER_ADDR") or first_slurm_node(env["SLURM_STEP_NODELIST"])
        coord = f"{host}:{env.get('MASTER_PORT', '29500')}"
        world, rank = int(env["SLURM_NTASKS"]), int(env["SLURM_PROCID"])
        local = int(env.get("SLURM_LOCALID", rank))
    if world <= 1:
        return 0, 1, device
    if device.type == "cuda":
        device = dist.local_device(rank if local is None else local)
    dist.init_distributed(coord, world, rank, device=device)
    return rank, world, device


def build(cfg, device, logger, rank=0, world=1):
    """Renderer, criterion, optimizer, schedule, loaders and Trainer for
    `cfg` on `device`, resumed from cfg.render.resume_path when
    cfg.train.resume is set; over `world` ranks the train loader yields
    rank `rank`'s shard."""
    from gpnerf_tpu_torch.data.loader import DataLoader, build_batchsampler
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.train.checkpoint import load_checkpoint
    from gpnerf_tpu_torch.train.step import make_optimizer

    render = get("render", cfg.render.file)(cfg, device=device)
    render.init_variables(cfg.seed)
    criterion = get("criterion", cfg.train.criterion_file)(cfg)
    train_ds = get("dataset", cfg.dataset.train.file)(cfg, is_train=True)
    eval_ds = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)
    # dataset.img_num_per_gpu frames per loader batch, each its own step
    # (train/trainer.py), as tools/train.py sizes its loaders; over several
    # ranks each loads its own shard, one frame per step. The eval loader
    # is not distributed (tools/train.py:95-108).
    n = cfg.dataset.img_num_per_gpu
    train_loader = DataLoader(
        train_ds, build_batchsampler(cfg, train_ds, n, True, seed=cfg.seed + rank,
                                     is_distributed=world > 1, num_replicas=world, rank=rank),
        num_workers=cfg.workers)
    eval_loader = DataLoader(eval_ds, build_batchsampler(cfg, eval_ds, n, False))
    optimizer, scheduler, schedule = make_optimizer(render, cfg)
    last_epoch = load_checkpoint(cfg, render, optimizer)
    logger.info(f"total parameters: {sum(p.numel() for p in render.parameters())}")
    trainer = get("trainer", cfg.train.file)(
        cfg, render=render, criterion=criterion, optimizer=optimizer, scheduler=scheduler,
        lr_schedule=schedule, logger=logger, log_dir=cfg.log_dir,
        performance_indicator=cfg.pi, last_iter=last_epoch)
    if last_epoch >= 0:  # the schedule continues from the resumed epoch
        for _ in range((last_epoch + 1) * cfg.train.ep_iter):
            scheduler.step()
    return trainer, train_loader, eval_loader


def main(argv=None):
    args = parse_args(argv)
    cfg = default_cfg.clone()
    update_config(cfg, args)
    device = select_device(args.opts)

    import torch

    from gpnerf_tpu_torch.utils.logging_utils import create_logger

    from gpnerf_tpu_torch.utils import dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rank, world, device = init_multihost(device)
    seed = cfg.seed + rank
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    logger, _ = create_logger(cfg, rank=rank, phase="train")
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    logger.info(f"device: {device} ({name}), torch {torch.__version__}, process {rank}/{world}")
    logger.info(str(cfg))
    trainer, train_loader, eval_loader = build(cfg, device, logger, rank, world)
    try:
        while True:  # Trainer.train exits the process after max_epoch
            trainer.train(train_loader, eval_loader)
    finally:
        train_loader.close()
        dist.shutdown()


if __name__ == "__main__":
    main()
