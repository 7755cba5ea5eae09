from gpnerf_tpu_torch.config.default import cfg, update_config
from gpnerf_tpu_torch.config.yacs_compat import CfgNode

__all__ = ["cfg", "update_config", "CfgNode"]
