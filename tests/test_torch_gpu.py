"""Tests of the port that need a CUDA device. They carry the `gpu` marker
and skip without a card; on the GPU machine run them with

    python -m pytest tests/test_torch_gpu.py -m gpu -q

They import only torch and the port (the GPU machine has no flax): the
point-stage CUDA kernel against its plain version at ragged sizes, the
wrapper's refusal of other forms, and a 128^2 render on the card against
the same render on the CPU."""

import os
import random

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.ops import point_stages as ps

CKPT = os.path.join(os.path.dirname(__file__), "..", "artifacts", "bench_ckpt.pth")


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _inputs(P, seed, dev):
    rs = np.random.RandomState(seed)
    V, C, C0, C1 = ps.V, ps.C, ps.C0, ps.C1
    gw0 = rs.rand(8, P).astype(np.float32)
    arrays = (
        rs.randint(-127, 128, size=(V * P, 4 * C)).astype(np.int8),
        (rs.rand(V, 4, P) * (rs.rand(V, 4, P) > 0.1)).astype(np.float32),
        (0.02 + rs.rand(C) * 0.05).astype(np.float32),
        (
            (rs.randint(0, 256, size=(P, 8 * C0)).astype(np.uint8),
             gw0 / gw0.sum(0), (0.01 + rs.rand(C0) * 0.03).astype(np.float32)),
            (rs.randint(-127, 128, size=(P, C1)).astype(np.int8),
             (rs.rand(1, P) > 0.05).astype(np.float32),
             (0.01 + rs.rand(C1) * 0.03).astype(np.float32)),
        ),
        (rs.rand(V, P) > 0.15).astype(np.float32),
        rs.rand(P) > 0.2,
    )

    def to(x):
        if isinstance(x, tuple):
            return tuple(to(y) for y in x)
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    torch.manual_seed(seed)
    head = NeRFHead(in_feat_ch=C - 3, n_smpl=8, code_dim=8).to(dev)
    return to(arrays) + (ps.pack_head_weights(head, fold_nch=C0),)


@pytest.mark.gpu
@pytest.mark.parametrize("P", [1, 255, 256, 1000, 70001])
def test_kernel_matches_plain(P):
    dev = _cuda()
    args = _inputs(P, P, dev)
    before = ps.fused_point_stages.launches
    a, rgb = ps.fused_point_stages(*args)
    torch.cuda.synchronize()
    assert ps.fused_point_stages.launches == before + 1
    a_p, rgb_p = ps.point_stages_plain(*args)
    a, rgb, a_p, rgb_p = (t.cpu().numpy() for t in (a, rgb, a_p, rgb_p))
    assert np.isfinite(a).all() and np.isfinite(rgb).all()
    # bf16 dot inputs summed in another order: a float32 ulp can move one
    # input across a bf16 rounding edge for a few points (tests/
    # test_torch_point_stages.py); all points within the bounds of
    # tests/test_pallas_point.py, nearly all within 1e-4
    d = np.abs(a - a_p)
    assert d.max() < 0.08 and (d > 1e-4).mean() <= 0.005
    agree = (a > 1e-14) == (a_p > 1e-14)
    assert (~agree).sum() <= max(1, 0.001 * P)
    dr = np.abs(rgb - rgb_p)[agree]
    assert dr.max() < 0.08 and (dr > 1e-4).mean() <= 0.005


@pytest.mark.gpu
def test_kernel_refuses_other_forms():
    dev = _cuda()
    rows, w4, pscale, geom, vmask, sig_ok, weights = _inputs(300, 0, dev)
    with pytest.raises(NotImplementedError, match="rows"):
        ps.fused_point_stages(rows.to(torch.int16), w4, pscale, geom, vmask, sig_ok, weights)
    with pytest.raises(NotImplementedError, match="geometry"):
        ps.fused_point_stages(rows, w4, pscale, geom[:1], vmask, sig_ok, weights)


@pytest.mark.gpu
def test_render_on_card_matches_cpu():
    dev = _cuda()
    from gpnerf_tpu_torch.config import cfg as base
    from gpnerf_tpu_torch.registry import get
    from gpnerf_tpu_torch.render.base import batch_to_device
    from gpnerf_tpu_torch.train.checkpoint import load_eval_model

    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file("configs/synthetic.yaml")
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.tpu.matmul_dtype = "float32"
    cfg.tpu.ray_cap = 16384
    cfg.freeze()
    np.random.seed(0)
    random.seed(0)
    batch = get("dataset", cfg.dataset.test.file)(cfg, is_train=False)[0]
    outs = {}
    for d in (dev, torch.device("cpu")):
        r = load_eval_model(CKPT, get("render", "demo_render")(cfg, device=d))
        outs[d.type] = {k: v.cpu() for k, v in r.render_demo_fn()(batch_to_device(batch, d)).items()}
    g, c = outs["cuda"], outs["cpu"]
    assert (g["mask_at_box"] == c["mask_at_box"]).float().mean() > 0.999
    np.testing.assert_array_equal(g["overflows"].numpy()[[0, 2, 3]], 0)
    assert abs(int(g["counts"][2]) - int(c["counts"][2])) <= 0.001 * int(c["counts"][2])
    m = g["mask_at_box"] & c["mask_at_box"]
    d = (g["pred_chw"].reshape(3, -1)[:, m] - c["pred_chw"].reshape(3, -1)[:, m]).abs()
    assert float(d.median()) < 2e-3 and float(d.max()) < 0.05
