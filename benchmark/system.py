"""The system under test: the PyTorch and CUDA port, `gpnerf_tpu_torch`,
reached only through its public entry points. Nothing here imports JAX or
the JAX package."""

from __future__ import annotations

from benchmark.reference.build import check_weights


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


def data_layer():
    from gpnerf_tpu_torch.data.base import HumanNVSDataset

    return HumanNVSDataset


def to_device(batch, device):
    from gpnerf_tpu_torch.render.base import batch_to_device

    return batch_to_device(batch, device)


def demo_renderer(conf, device):
    """The progressive renderer (`render/demo.py` build_render) with the
    configuration's weights."""
    from gpnerf_tpu_torch.render.demo import build_render
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    render = build_render(port_cfg(conf, device), device=device)
    load_eval_model(check_weights(conf["weights"]), render)
    return render.eval()


class TrainStep:
    """The port's training step (`train/step.py` train_step) over the
    training renderer (`render/base.py` build_render) from the
    configuration's weights, its criterion and its AdamW."""

    def __init__(self, conf, device):
        from gpnerf_tpu_torch.render.base import build_render
        from gpnerf_tpu_torch.train.checkpoint import load_eval_model
        from gpnerf_tpu_torch.train.criterion import build_criterion
        from gpnerf_tpu_torch.train.step import make_optimizer

        cfg = port_cfg(conf, device)
        self.render = build_render(cfg, device=device)
        load_eval_model(check_weights(conf["weights"]), self.render)
        self.criterion = build_criterion(cfg)
        self.optimizer, self.scheduler, _ = make_optimizer(self.render, cfg)

    def __call__(self, batch, t_rand):
        from gpnerf_tpu_torch.train.step import train_step

        return train_step(self.render, self.criterion, self.optimizer, self.scheduler, batch,
                          t_rand=t_rand)
