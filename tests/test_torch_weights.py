"""Checkpoint interop of the port (gpnerf_tpu_torch/train/checkpoint.py):
the port's modules carry the reference key layout, so a strict
`load_state_dict` of artifacts/bench_ckpt.pth fills them, and
`from_jax_variables` carries the JAX package's loaded variables into the
same tensors."""

import os
import random

import jax
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.train.checkpoint import (
    from_jax_variables,
    key_map,
    load_eval_model,
)

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _cfg(base):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 64
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def port_model():
    model = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    return load_eval_model(CKPT, model)


@pytest.fixture(scope="module")
def jax_state():
    cfg = _cfg(jax_cfg)
    np.random.seed(0)
    random.seed(0)
    batch = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    render = jax_get("render", "demo_render")(cfg)
    # the variables tree's structure and shapes, without running the init
    shapes = jax.eval_shape(
        lambda key: render._init_variables_impl(key, batch), jax.random.PRNGKey(0)
    )
    template = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    variables = jax_load(CKPT, template, 4)
    return from_jax_variables(jax.tree_util.tree_map(np.asarray, variables))


def test_strict_load_fills_every_tensor(port_model):
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)["state_dict"]
    state = port_model.state_dict()
    assert set(state) == set(ckpt) and len(state) == 223
    for k, v in ckpt.items():
        np.testing.assert_array_equal(
            state[k].numpy().reshape(-1), v.numpy().reshape(-1), err_msg=k
        )


def test_from_jax_variables_equals_strict_load(port_model, jax_state):
    state = port_model.state_dict()
    assert set(jax_state) == set(state)
    for k, v in jax_state.items():
        if k.endswith("num_batches_tracked"):
            continue  # a bookkeeping counter the JAX tree does not carry
        assert v.shape == state[k].shape, k
        np.testing.assert_array_equal(v.numpy(), state[k].numpy(), err_msg=k)


def test_from_jax_variables_loads_strictly(jax_state):
    model = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    model.load_state_dict(jax_state, strict=True)
    w = model.nerfhead.sigmahead.xyzc_net.net[3][0].weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        jax_state["nerfhead.sigmahead.xyzc_net.net.3.0.weight"].numpy(),
    )


def test_key_map_covers_the_checkpoint():
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)["state_dict"]
    mapped = {tk for tk, *_ in key_map()}
    counters = {k for k in ckpt if k.endswith("num_batches_tracked")}
    assert mapped | counters == set(ckpt)
    assert len(mapped) == len({tk for tk, *_ in key_map()}) == 209


def test_strict_load_rejects_a_missing_key(tmp_path):
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)["state_dict"]
    del ckpt["nerfhead.rgbhead.rgb_fc.4.bias"]
    path = tmp_path / "partial.pth"
    torch.save({"state_dict": ckpt}, path)
    model = port_get("render", "demo_render")(_cfg(port_cfg), device="cpu")
    with pytest.raises(RuntimeError, match="rgb_fc.4.bias"):
        load_eval_model(str(path), model)
