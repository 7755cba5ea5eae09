"""The system under test: the PyTorch and CUDA port, `gpnerf_tpu_torch`,
reached only through its public entry points. Nothing here imports JAX or
the JAX package.

A configuration file may name what its cells run and what checks them:

  * `"program": {"views": <name>, "train_steps": <name>}`: for each loop,
    a builder of kind `render` in the port's registry (`registry.get`);
    a loop the key leaves out runs GP-NeRF's (`PROGRAMS`);
  * `"reference": <dotted module>`: the plain reference that decides
    `correct` (`REFERENCE` without the key), with `render_items`,
    `train_readings` and `train_sites` as `benchmark/reference/tasks.py`
    has them.

The criterion of a train step is the registry's `criterion` builder that
the port's configuration names (`train.criterion_file`).
"""

from __future__ import annotations

import importlib

from benchmark.reference.build import check_weights

PROGRAMS = {"views": "DemoRender", "train_steps": "BaseRender"}
REFERENCE = "benchmark.reference.tasks"


def float32_without_tf32():
    """cuBLAS and cuDNN compute float32 as float32, as both configurations
    state (the port leaves the flags to its entry points; cuDNN's default
    is TF32)."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def port_cfg(conf, device):
    """The port's configuration tree: its defaults with every key of the
    configuration file's `cfg` set."""
    from gpnerf_tpu_torch.config import cfg as default
    from gpnerf_tpu_torch.config.yacs_compat import CfgNode

    cfg = default.clone()
    cfg.defrost()
    cfg.merge_from_other_cfg(CfgNode(conf["cfg"]))
    cfg.device = device.type
    cfg.freeze()
    return cfg


def builder(conf, loop):
    """The registry's `render` builder that runs the loop `loop` for the
    configuration; a name the registry lacks stops the run."""
    from gpnerf_tpu_torch.registry import get

    name = conf.get("program", {}).get(loop, PROGRAMS[loop])
    try:
        return get("render", name)
    except KeyError:
        raise SystemExit(f"configuration {conf['name']!r}: program.{loop} is {name!r}, "
                         "which the port's registry holds no `render` builder for") from None


def reference_name(conf):
    return conf.get("reference", REFERENCE)


def reference(conf):
    """The configuration's reference module."""
    return importlib.import_module(reference_name(conf))


def data_layer():
    from gpnerf_tpu_torch.data.base import HumanNVSDataset

    return HumanNVSDataset


def to_device(batch, device):
    from gpnerf_tpu_torch.render.base import batch_to_device

    return batch_to_device(batch, device)


def views_program(conf, device):
    """The program of the `views` loop (GP-NeRF's: the progressive renderer,
    `render/demo.py`) with the configuration's weights, in eval mode."""
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    render = builder(conf, "views")(port_cfg(conf, device), device=device)
    load_eval_model(check_weights(conf["weights"]), render)
    return render.eval()


class TrainStep:
    """The port's training step (`train/step.py` train_step) over the
    program of the `train_steps` loop (GP-NeRF's: the training renderer,
    `render/base.py`) from the configuration's weights, its criterion and
    its AdamW."""

    def __init__(self, conf, device):
        from gpnerf_tpu_torch.registry import get
        from gpnerf_tpu_torch.train.checkpoint import load_eval_model
        from gpnerf_tpu_torch.train.step import make_optimizer

        cfg = port_cfg(conf, device)
        self.render = builder(conf, "train_steps")(cfg, device=device)
        load_eval_model(check_weights(conf["weights"]), self.render)
        self.criterion = get("criterion", cfg.train.criterion_file)(cfg)
        self.optimizer, self.scheduler, _ = make_optimizer(self.render, cfg)

    def __call__(self, batch, t_rand):
        from gpnerf_tpu_torch.train.step import train_step

        return train_step(self.render, self.criterion, self.optimizer, self.scheduler, batch,
                          t_rand=t_rand)
