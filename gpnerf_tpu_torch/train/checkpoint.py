"""Checkpoints (gpnerf_tpu/train/checkpoint.py + the key map of
gpnerf_tpu/train/torch_interop.py).

The port's modules carry the reference's torch key layout (`encoder.*`,
`nerfhead.sigmahead.*`, `nerfhead.rgbhead.*`), so `load_state_dict(strict=
True)` on a reference-format .pth is the whole loader, and the model's own
`state_dict()` is what a checkpoint stores. `save_checkpoint` writes the
reference .pth layout ('epoch', 'model', 'performance/<pi>', 'state_dict',
'optimizer'); the optimizer entry is torch's AdamW state, which
`load_checkpoint` resumes. `from_jax_variables`
carries the JAX package's variables tree (parameters and batch statistics,
as numpy arrays) into the same layout:

  * Conv2d: flax (kh, kw, ci, co) -> torch (co, ci, kh, kw)
  * Linear: flax (in, out) -> torch (out, in)
  * sparse conv: (27, ci, co) -> spconv (kD, kH, kW, ci, co)
  * BatchNorm1d: params scale/bias + batch_stats mean/var -> weight/bias +
    running_mean/running_var (num_batches_tracked = 0)
  * InstanceNorm2d / LayerNorm: scale/bias -> weight/bias
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List, Tuple

import numpy as np
import torch

_Entry = Tuple[str, str, Tuple[str, ...], str]  # torch key, collection, path, kind


def _encoder_map(blocks=(3, 4, 6)) -> List[_Entry]:
    m = []

    def conv(tk, fp, bias=False):
        m.append((tk + ".weight", "params", fp + ("kernel",), "conv2d"))
        if bias:
            m.append((tk + ".bias", "params", fp + ("bias",), "raw"))

    def norm(tk, fp):
        m.append((tk + ".weight", "params", fp + ("scale",), "raw"))
        m.append((tk + ".bias", "params", fp + ("bias",), "raw"))

    conv("encoder.conv1", ("encoder", "conv1"))
    norm("encoder.bn1", ("encoder", "bn1"))
    for lname, n in zip(("layer1", "layer2", "layer3"), blocks):
        for b in range(n):
            base = f"encoder.{lname}.{b}"
            fb = ("encoder", f"{lname}_{b}")
            conv(base + ".conv1", fb + ("conv1", "Conv_0"))
            norm(base + ".bn1", fb + ("bn1",))
            conv(base + ".conv2", fb + ("conv2", "Conv_0"))
            norm(base + ".bn2", fb + ("bn2",))
            if b == 0:
                conv(base + ".downsample.0", fb + ("ds_conv", "Conv_0"))
                norm(base + ".downsample.1", fb + ("ds_norm",))
    for tname, fname in (
        ("encoder.upconv3.conv", "upconv3"),
        ("encoder.iconv3", "iconv3"),
        ("encoder.upconv2.conv", "upconv2"),
        ("encoder.iconv2", "iconv2"),
    ):
        conv(tname + ".conv", ("encoder", fname, "conv", "Conv_0"), bias=True)
        norm(tname + ".bn", ("encoder", fname, "bn"))
    conv("encoder.out_conv", ("encoder", "out_conv"), bias=True)
    return m


def _sparse_block_map(tprefix, fprefix, double) -> List[_Entry]:
    m = []

    def bn(tk, fp):
        m.append((tk + ".weight", "params", fp + ("scale",), "raw"))
        m.append((tk + ".bias", "params", fp + ("bias",), "raw"))
        m.append((tk + ".running_mean", "batch_stats", fp + ("mean",), "raw"))
        m.append((tk + ".running_var", "batch_stats", fp + ("var",), "raw"))

    if double:
        m.append((tprefix + ".0.weight", "params", fprefix + ("w0",), "sparse"))
        bn(tprefix + ".1", fprefix + ("bn0",))
        m.append((tprefix + ".3.weight", "params", fprefix + ("w1",), "sparse"))
        bn(tprefix + ".4", fprefix + ("bn1",))
    else:
        m.append((tprefix + ".0.weight", "params", fprefix + ("w",), "sparse"))
        bn(tprefix + ".1", fprefix + ("bn",))
    return m


def _mlp_map(tprefix, fprefix, n_layers) -> List[_Entry]:
    m = []
    for k in range(n_layers):
        fp = fprefix + (f"dense_{k}",)
        m.append((f"{tprefix}.{2 * k}.weight", "params", fp + ("kernel",), "linear"))
        m.append((f"{tprefix}.{2 * k}.bias", "params", fp + ("bias",), "raw"))
    return m


def _head_map(n_layers=4) -> List[_Entry]:
    sig = ("head", "sigmahead")
    m = [("nerfhead.sigmahead.c.weight", "params", sig + ("c",), "raw")]
    attn = sig + ("xyzc_attn",)
    for w in ("w_qs", "w_ks", "w_vs", "fc"):
        m.append((f"nerfhead.sigmahead.xyzc_attn.{w}.weight", "params",
                  attn + (w, "kernel"), "linear"))
    for tk, fk in (("weight", "scale"), ("bias", "bias")):
        m.append((f"nerfhead.sigmahead.xyzc_attn.layer_norm.{tk}", "params",
                  attn + ("layer_norm", fk), "raw"))
    net = sig + ("xyzc_net",)
    tnet = "nerfhead.sigmahead.xyzc_net.net"
    m += _sparse_block_map(f"{tnet}.0", net + ("subm0",), True)
    for i in range(n_layers):
        m += _sparse_block_map(f"{tnet}.{2 * i + 1}", net + (f"down{i}",), False)
        m += _sparse_block_map(f"{tnet}.{2 * i + 2}", net + (f"subm{i + 1}",), True)
    m += _mlp_map("nerfhead.sigmahead.out_geometry_fc", sig + ("out_geometry_fc",), 1)
    rgb = ("head", "rgbhead")
    m += _mlp_map("nerfhead.rgbhead.base_fc", rgb + ("base_fc",), 2)
    m += _mlp_map("nerfhead.rgbhead.vis_fc", rgb + ("vis_fc",), 2)
    m += _mlp_map("nerfhead.rgbhead.rgb_fc", rgb + ("rgb_fc",), 3)
    m += _mlp_map("nerfhead.rgbhead.out_geometry_fc", rgb + ("out_geometry_fc",), 4)
    return m


def key_map(n_layers=4, encoder_blocks=(3, 4, 6)) -> List[_Entry]:
    """(torch key, flax collection, flax path, transform kind) for every
    tensor of the reference checkpoint except num_batches_tracked."""
    return _encoder_map(encoder_blocks) + _head_map(n_layers)


def _to_torch(a, kind):
    a = np.asarray(a)
    if kind == "conv2d":
        return a.transpose(3, 2, 0, 1)
    if kind == "linear":
        return a.T
    if kind == "sparse":
        return a.reshape(3, 3, 3, a.shape[1], a.shape[2])
    return a


def from_jax_variables(variables, n_layers=4) -> Dict[str, torch.Tensor]:
    """JAX variables {'encoder': {...}, 'head': {...}} (numpy leaves) ->
    a state_dict for the port's renderers (reference key layout).

    A params-shaped tree without collections, {'encoder': enc_params,
    'head': head_params} (a JAX gradient tree, as `jax.grad` of the train
    step's loss returns it), maps to the parameter keys only: the
    gradient of each parameter under its state-dict key."""
    grads_only = "params" not in variables["encoder"]
    if grads_only:
        variables = {k: {"params": v} for k, v in variables.items()}
    enc = variables["encoder"]["params"]
    blocks = tuple(
        sum(1 for k in enc if k.startswith(f"layer{i}_")) for i in (1, 2, 3)
    )
    state = {}
    for tk, coll, path, kind in key_map(n_layers, blocks):
        if grads_only and coll != "params":
            continue
        tree = variables[path[0]][coll]
        for p in path[1:]:
            tree = tree[p]
        state[tk] = torch.from_numpy(np.array(_to_torch(tree, kind), dtype=np.float32))
        if tk.endswith(".running_mean"):
            state[tk[: -len("running_mean")] + "num_batches_tracked"] = torch.tensor(0)
    return state


def save_checkpoint(states, is_best, output_dir, filename="checkpoint.pth"):
    """Write `states` (the reference layout: 'epoch', 'model',
    'performance/<pi>', 'state_dict', 'optimizer') to output_dir/filename;
    when `is_best`, also the bare state dict to model_best.pth."""
    os.makedirs(output_dir, exist_ok=True)
    torch.save(states, os.path.join(output_dir, filename))
    if is_best:
        torch.save(states["state_dict"], os.path.join(output_dir, "model_best.pth"))


def load_checkpoint(cfg, model, optimizer=None):
    """Resume (reference utils.py:77-122): with cfg.train.resume and
    cfg.render.resume_path, load the state dict into `model` (non-strict,
    as the JAX package does), the optimizer state when the file has one
    that fits, and return the checkpoint's epoch; -1 without resume. A
    configured path that does not exist raises FileNotFoundError."""
    path = cfg.render.resume_path
    if not (path and cfg.train.resume):
        return -1
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    model.load_state_dict(state, strict=False)
    if optimizer is not None and isinstance(ckpt, dict) and "optimizer" in ckpt:
        try:
            optimizer.load_state_dict(ckpt["optimizer"])
        except (ValueError, KeyError, TypeError) as e:
            # an optax state (a JAX-written checkpoint) does not fit a torch
            # optimizer; the JAX package skips the mismatch the same way
            logging.warning(f"optimizer state not resumable: {e}")
    return int(ckpt["epoch"]) if isinstance(ckpt, dict) and "epoch" in ckpt else -1


def load_eval_model(resume_path, model):
    """Strict load of a reference-format checkpoint (`{'state_dict': ...}` or
    a bare state_dict) into `model`; returns the model."""
    if not os.path.exists(resume_path):
        raise FileNotFoundError(resume_path)
    ckpt = torch.load(resume_path, map_location="cpu", weights_only=False)
    state = ckpt["state_dict"] if isinstance(ckpt, dict) and "state_dict" in ckpt else ckpt
    model.load_state_dict(state, strict=True)
    return model
