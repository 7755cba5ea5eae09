"""spconv 2.x's sparse weight layout in a checkpoint
(gpnerf_tpu_torch/models/sparse_net.py `SparseConvWeight`; JAX
gpnerf_tpu/train/torch_interop.py `_from_torch`).

`artifacts/bench_ckpt.pth` stores its sparse conv weights in spconv 1.2.1's
(kD, kH, kW, Cin, Cout). Here every one of them is permuted into spconv
2.x's (Cout, Cin, kD, kH, kW) and the file written under `tmp_path`. The
port must load it, strict (`load_eval_model`) and non-strict
(`load_checkpoint`), into a state equal bit for bit to the one the
unpermuted file gives; the JAX package's `load_eval_model` must load it too,
into variables whose `from_jax_variables` equals that state. Equal state
means an equal render, so nothing is rendered. A sparse weight of neither
layout still fails the size check."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.render.base import build_render
from gpnerf_tpu_torch.train.checkpoint import (
    from_jax_variables,
    key_map,
    load_checkpoint,
    load_eval_model,
)

ROOT = os.path.join(os.path.dirname(__file__), "..")
CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
SPARSE = [k for k, _, _, kind in key_map() if kind == "sparse"]


def _cfg(base, **extra):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = 128
    cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    for k, v in extra.items():
        node, *path = k.split(".")
        tgt = cfg[node]
        for p in path[:-1]:
            tgt = tgt[p]
        tgt[path[-1]] = v
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """(the checkpoint's state, the path of its spconv 2.x copy)."""
    ckpt = torch.load(CKPT, map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    v2 = dict(state)
    for k in SPARSE:
        assert tuple(state[k].shape[:3]) == (3, 3, 3), k
        v2[k] = state[k].permute(4, 3, 0, 1, 2).contiguous()  # (co, ci, kd, kh, kw)
    path = str(tmp_path_factory.mktemp("spconv2") / "v2.pth")
    torch.save({"epoch": 7, "state_dict": v2}, path)
    return state, path


@pytest.fixture(scope="module")
def reference_state(files):
    r = build_render(_cfg(port_cfg), device="cpu")
    load_eval_model(CKPT, r)
    return r.state_dict()


def _assert_same_bits(a, b):
    assert set(a) == set(b)
    for k in a:
        assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k


def test_sparse_weights_are_permuted_in_the_copy(files):
    """The copy really holds the 2.x layout: 14 weights, none of them of
    (3, 3, 3, ...) shape."""
    state, path = files
    v2 = torch.load(path, map_location="cpu", weights_only=False)["state_dict"]
    assert len(SPARSE) == 14
    for k in SPARSE:
        assert tuple(v2[k].shape[2:]) == (3, 3, 3) and tuple(v2[k].shape[:3]) != (3, 3, 3), k


@pytest.mark.parametrize("how", ["strict", "resume"])
def test_port_loads_spconv2_layout_bitwise(files, reference_state, how):
    """load_eval_model (strict) and load_checkpoint (the non-strict resume)
    give the unpermuted checkpoint's state, bit for bit; the state it saves
    again is in 1.2.1's layout."""
    _, path = files
    r = build_render(_cfg(port_cfg), device="cpu")
    if how == "strict":
        load_eval_model(path, r)
    else:
        cfg = _cfg(port_cfg, **{"train.resume": True, "render.resume_path": path})
        assert load_checkpoint(cfg, r) == 7
    state = r.state_dict()
    _assert_same_bits(state, reference_state)
    assert all(tuple(state[k].shape[:3]) == (3, 3, 3) for k in SPARSE)


def test_jax_loads_spconv2_layout_to_the_same_state(files, reference_state):
    """The JAX package reads the same file into the state the port holds
    (every parameter and running statistic, bitwise)."""
    _, path = files
    cfg = _cfg(jax_cfg)
    random.seed(0)
    np.random.seed(0)
    frame = jax_get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    jr = jax_get("render", "BaseRender")(cfg)
    shapes = jax.eval_shape(lambda: jr.init_variables(0, frame))
    variables = jax_load(path, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)
    carried = from_jax_variables(jax.tree.map(np.asarray, variables))
    keys = [k for k in reference_state if not k.endswith("num_batches_tracked")]
    assert set(keys) == {k for k in carried if not k.endswith("num_batches_tracked")}
    for k in keys:
        assert torch.equal(carried[k], reference_state[k]), k


def test_wrong_sparse_shape_still_raises(files):
    """A sparse weight of neither layout fails load_state_dict's size check."""
    state, _ = files
    bad = dict(state)
    k = SPARSE[0]
    bad[k] = torch.zeros(3, 3, state[k].shape[3], state[k].shape[4], 3)
    r = build_render(_cfg(port_cfg), device="cpu")
    with pytest.raises(RuntimeError, match="size mismatch"):
        r.load_state_dict(bad, strict=True)
