"""String-keyed builder registry: the JAX package's `get("render",
cfg.render.file)` surface (gpnerf_tpu/registry.py), restricted to what the
port provides."""

from __future__ import annotations

from typing import Callable, Dict

_REGISTRY: Dict[str, Dict[str, Callable]] = {}

# reference module-name aliases -> canonical registry names
_ALIASES = {
    ("head", "BaseNeRFHead"): "trainhead",
    ("render", "demo_render"): "DemoRender",
}


def register(kind: str, name: str, builder: Callable) -> Callable:
    _REGISTRY.setdefault(kind, {})[name] = builder
    return builder


def get(kind: str, name: str) -> Callable:
    name = _ALIASES.get((kind, name), name)
    import gpnerf_tpu_torch.data.synthetic_dataset  # noqa: F401
    import gpnerf_tpu_torch.data.thuman  # noqa: F401
    import gpnerf_tpu_torch.data.zjumocap  # noqa: F401
    import gpnerf_tpu_torch.models.encoder  # noqa: F401
    import gpnerf_tpu_torch.models.heads  # noqa: F401
    import gpnerf_tpu_torch.render.base  # noqa: F401
    import gpnerf_tpu_torch.render.demo  # noqa: F401
    import gpnerf_tpu_torch.render.neural_body  # noqa: F401
    import gpnerf_tpu_torch.train.criterion  # noqa: F401
    import gpnerf_tpu_torch.train.trainer  # noqa: F401

    try:
        return _REGISTRY[kind][name]
    except KeyError:
        known = sorted(_REGISTRY.get(kind, {}))
        raise KeyError(
            f"No builder registered for {kind!r}/{name!r}; known: {known}"
        ) from None
