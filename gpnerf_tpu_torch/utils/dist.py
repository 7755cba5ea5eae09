"""Distributed runtime helpers (gpnerf_tpu/utils/dist.py; reference
libs/utils/misc.py:93-160, 341-407) over `torch.distributed`.

One process per device: rank r runs on `local_device()`, cuda:(local rank
% the cards it sees). The backend is NCCL when the ranks hold CUDA devices
and gloo on the CPU (or when asked for, e.g. several ranks sharing one
card, which NCCL refuses). Single-process calls are no-ops that report rank
0 of a world of 1, as the JAX package's do. The tensor collectives of the
data-parallel step live in parallel/dp.py; these helpers are the host-side
control plane: rank and world queries, main-process gating, a dict of
scalars reduced across ranks, an all-gather of picklable objects and a
barrier."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def init_distributed(coordinator=None, num_processes=None, process_id=None, backend=None,
                     device=None):
    """Join the process group of `num_processes` ranks as rank `process_id`
    (reference tools/train.py:125-131). `coordinator` is "host:port" or an
    init URL ("tcp://host:port", "env://"). `backend` defaults to NCCL when
    `device` is a CUDA device, else gloo. A no-op for one process or when the
    group exists."""
    if num_processes is None or int(num_processes) <= 1 or dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if device is not None and torch.device(device).type == "cuda" else "gloo"
    url = coordinator if coordinator and "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=url, world_size=int(num_processes),
                            rank=int(process_id or 0))


def shutdown():
    """Leave the process group (a no-op without one)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def is_dist_avail_and_initialized() -> bool:
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def is_main_process() -> bool:
    return get_rank() == 0


def local_device(local_rank=None):
    """This rank's CUDA device, cuda:(local rank % device count), made
    current; `local_rank` defaults to LOCAL_RANK (torchrun), else the
    rank."""
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", get_rank()))
    dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    return dev


def _comm_device():
    """Where the default group's collectives take their tensors: the current
    card under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def reduce_dict(input_dict, average=True):
    """The mean (or sum) over ranks of a dict of scalars (misc.py:136-160),
    as Python floats; the identity, in floats, on one process."""
    if get_world_size() < 2:
        return {k: float(v) for k, v in input_dict.items()}
    keys = sorted(input_dict)
    vec = torch.tensor([float(input_dict[k]) for k in keys], dtype=torch.float64,
                       device=_comm_device())
    dist.all_reduce(vec)
    if average:
        vec /= get_world_size()
    return dict(zip(keys, vec.tolist()))


def all_gather(data):
    """Every rank's picklable `data`, in rank order (misc.py:93-133)."""
    if get_world_size() < 2:
        return [data]
    out = [None] * get_world_size()
    dist.all_gather_object(out, data)
    return out


def barrier():
    if get_world_size() > 1:
        dist.barrier()
