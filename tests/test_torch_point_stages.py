"""The port's point-stage kernel module (gpnerf_tpu_torch/ops/point_stages.py)
against the JAX package's Pallas megakernel `fused_point_stages_tabs`, run
in interpret mode on the CPU, in the form the fast render path uses (form
(a): one merged int8 quad table, a u8 level-1 octet geometry table and an
int8 folded-coarse nearest table, occ_geom off). Both sides round every dot
input to bf16 and accumulate in float32."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.models.heads import NeRFRGBHead
from gpnerf_tpu.models.layers import MLP as JaxMLP
from gpnerf_tpu.ops.grid_sample import (
    NearestTable,
    build_octet_table_3d,
    nearest_row_and_weight,
    octet_rows_and_weights,
)
from gpnerf_tpu.ops.pallas_point import fused_point_stages_tabs
from gpnerf_tpu.ops.pallas_point import pack_head_weights as jax_pack
from gpnerf_tpu_torch.models.heads import NeRFHead
from gpnerf_tpu_torch.ops import point_stages as ps

P, V, C, C1, CC = 700, 3, 35, 32, 64


def _port_head(rgb_params, sf_params):
    """A port NeRFHead carrying the flax head weights (Dense kernels are
    (in, out); torch Linear weights (out, in))."""
    head = NeRFHead(in_feat_ch=C - 3, n_smpl=8, code_dim=8)

    def load(mlp, tree, n):
        lins = [m for m in mlp if isinstance(m, torch.nn.Linear)]
        assert len(lins) == n
        for k, lin in enumerate(lins):
            kern = np.asarray(tree[f"dense_{k}"]["kernel"]).T
            with torch.no_grad():
                lin.weight.zero_()
                lin.weight[:, : kern.shape[1]] = torch.from_numpy(kern.copy())
                lin.bias.copy_(torch.from_numpy(np.array(tree[f"dense_{k}"]["bias"])))

    rh = head.rgbhead
    load(rh.out_geometry_fc, rgb_params["out_geometry_fc"], 4)
    load(rh.base_fc, rgb_params["base_fc"], 2)
    load(rh.vis_fc, rgb_params["vis_fc"], 2)
    load(rh.rgb_fc, rgb_params["rgb_fc"], 3)
    load(head.sigmahead.out_geometry_fc, sf_params, 1)
    return head


def make_form_a():
    """Seeded inputs in the style of tests/test_pallas_point.py:106, laid
    out as the fast path feeds the kernel."""
    rs = np.random.RandomState(1)
    rgbhead = NeRFRGBHead(in_feat_ch=C - 3)
    rgb_vars = rgbhead.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 2, V, C)), jnp.zeros((2, 2, 64)),
        jnp.zeros((2, 2, V, 1)),
    )
    sf_mlp = JaxMLP((64,), ("elu",))
    sf_vars = sf_mlp.init(jax.random.PRNGKey(1), jnp.zeros((2, C1 + CC)))
    head_params = {
        "sigmahead": {"out_geometry_fc": sf_vars["params"]},
        "rgbhead": rgb_vars["params"],
    }
    D = Hh = W = 7
    vol1 = rs.randint(0, 255, size=(D, Hh, W, C1)).astype(np.uint8)
    oct1 = build_octet_table_3d(jnp.asarray(vol1))
    sc1 = (0.01 + rs.rand(C1) * 0.03).astype(np.float32)
    volc = rs.randint(-127, 127, size=(D, Hh, W, CC)).astype(np.int8)
    ntab = NearestTable(jnp.asarray(volc.reshape(-1, CC)), (D, Hh, W), 2)
    scc = (0.01 + rs.rand(CC) * 0.03).astype(np.float32)
    size = jnp.asarray([D, Hh, W])
    pos = jnp.asarray(
        (rs.rand(P, 3) * (np.array([D, Hh, W]) + 0.5) - 0.5).astype(np.float32)
    )  # includes out-of-extent points (zeros outside)
    g0, gw0 = octet_rows_and_weights(oct1, pos, size)
    g1, gw1 = nearest_row_and_weight(ntab, pos, size)
    rows = rs.randint(-127, 127, size=(V * P, 4 * C)).astype(np.int8)
    w4 = np.abs(rs.rand(V, 4, P)).astype(np.float32)
    w4 *= rs.rand(V, 4, P) > 0.1
    pscale = (0.02 + rs.rand(C) * 0.05).astype(np.float32)
    vmask = (rs.rand(V, P) > 0.15).astype(np.float32)
    sig_ok = rs.rand(P) > 0.2
    geom = [
        (np.asarray(g0), np.asarray(gw0).T.copy(), sc1),
        (np.asarray(g1), np.asarray(gw1).T.copy(), scc),
    ]
    a_j, rgb_j = fused_point_stages_tabs(
        ((jnp.asarray(rows), jnp.asarray(w4), jnp.asarray(pscale)),),
        None, jnp.asarray(vmask), jnp.asarray(sig_ok),
        jax_pack(head_params, C, fold_nch=C1),
        geom_tabs=tuple(tuple(jnp.asarray(x) for x in g) for g in geom),
        block=256, interpret=True,
    )
    head = _port_head(rgb_vars["params"], sf_vars["params"])
    args = (
        torch.from_numpy(rows), torch.from_numpy(w4), torch.from_numpy(pscale),
        tuple(tuple(torch.from_numpy(x) for x in g) for g in geom),
        torch.from_numpy(vmask), torch.from_numpy(sig_ok),
        ps.pack_head_weights(head, fold_nch=C1),
    )
    return {
        "args": args, "head": head, "head_params": head_params,
        "jax": (np.asarray(a_j), np.asarray(rgb_j)),
    }


@pytest.fixture(scope="module")
def form_a():
    return make_form_a()


def test_plain_matches_pallas_kernel_interpret(form_a):
    a_j, rgb_j = form_a["jax"]
    a, rgb = (t.numpy() for t in ps.point_stages_plain(*form_a["args"]))
    # same bf16-input / f32-accumulate numerics, sums in another order: a
    # float32 ulp can move a dot input across a bf16 rounding edge. With
    # these random inputs the variance channels reach ~1e2, where one bf16
    # ulp is ~0.5, so a single flip shifts that point's density visibly.
    # Measured: 1 of 700 alphas off by 0.058, one by 3e-5, the rest within
    # 6e-8; rgb within 2e-10.
    d = np.abs(a - a_j)
    assert (d > 1e-4).sum() <= 2, np.sort(d)[-4:]
    assert d.max() < 0.08
    alive, alive_j = a > 1e-14, a_j > 1e-14
    assert (alive != alive_j).sum() <= 1
    agree = alive == alive_j
    np.testing.assert_allclose(rgb[agree], rgb_j[agree], atol=1e-5, rtol=0)
    assert alive.mean() > 0.3 and (rgb[alive] > 0).all()


def test_plain_matches_float32_heads(form_a):
    """Wiring check against the port's own float32 heads (models/heads.py),
    with the bounds of tests/test_pallas_point.py:83-103."""
    rows, w4, pscale, geom, vmask, sig_ok, weights = form_a["args"]
    head = form_a["head"]
    a, rgb = (t.numpy() for t in ps.point_stages_plain(*form_a["args"]))
    rf = (
        rows.reshape(V, P, 4, C).float() * w4.permute(0, 2, 1)[..., None]
    ).sum(2) * pscale
    rf = rf.permute(1, 0, 2)  # (P, V, C)
    mean = rf.mean(dim=1, keepdim=True)
    var = ((rf - mean) ** 2).mean(dim=1, keepdim=True)
    f1 = (geom[0][0].reshape(P, 8, C1).float() * geom[0][1].T[..., None]).sum(1) * geom[0][2]
    fc = geom[1][0].float() * geom[1][1].T * geom[1][2]
    lin = head.sigmahead.out_geometry_fc[0]
    with torch.no_grad():
        sf = torch.nn.functional.elu(f1 @ lin.weight[:, :C1].T + fc + lin.bias)
        sigma = head.rgbhead.density(sf, mean[:, 0], var[:, 0], vmask.T.sum(-1, keepdim=True))[:, 0]
        sigma = torch.where(sig_ok, sigma, 0.0)
        a_ref = (1.0 - torch.exp(-sigma)).numpy()
        rgb_ref = head.rgbhead.color(rf[:, None], mean[:, None], var[:, None])[:, 0].numpy()
    alive_ref = (a_ref > 1e-14) & sig_ok.numpy()
    rgb_ref = np.where(alive_ref[:, None], rgb_ref, 0.0)
    np.testing.assert_allclose(a, a_ref, atol=0.08, rtol=0.3)
    assert np.abs(a - a_ref).mean() < 5e-3
    agree = (a > 1e-14) == alive_ref
    assert (~agree).mean() < 0.01
    np.testing.assert_allclose(rgb[agree], rgb_ref[agree], atol=0.08)
    assert np.abs(rgb[agree] - rgb_ref[agree]).mean() < 5e-3


def test_pack_head_weights_matches_jax(form_a):
    """The port's unpadded (Cout, Cin) weights equal the JAX packing with
    its 8-row sublane padding removed."""
    jw = [np.asarray(w) for w in jax_pack(form_a["head_params"], C, fold_nch=C1)]
    jl = list(zip(jw[0::2], jw[1::2]))
    Cp = 40  # _pad8(35)

    def unpad(w, blocks):
        parts, off = [], 0
        for b in blocks:
            parts.append(w[:, off : off + b])
            off += -(-b // 8) * 8
        return np.concatenate(parts, axis=1)

    jl[1] = (unpad(jl[1][0], [64, C, C]), jl[1][1])
    jl[5] = (unpad(jl[5][0], [C, C, C]), jl[5][1])
    assert jl[1][0].shape[1] == 64 + 2 * C and Cp == 40
    port = form_a["args"][-1].layers
    assert len(port) == len(jl) == 12
    for (w, b), (wj, bj) in zip(port, jl):
        np.testing.assert_array_equal(w.numpy(), wj)
        np.testing.assert_array_equal(b.numpy(), bj[:, 0])


def test_kernel_weight_layout(form_a):
    """The flat buffer the CUDA kernel stages in shared memory: per layer
    [Cout/4][Cin][4] bf16-rounded weights (outputs padded to 4), then all
    biases; 32,196 floats for C = 35."""
    pw = form_a["args"][-1]
    assert pw.flat.shape == (32196,)
    off = 0
    for w, _ in pw.layers:
        cout, cin = w.shape
        g = -(-cout // 4)
        blk = pw.flat[off : off + g * 4 * cin].reshape(g, cin, 4)
        wb = w.to(torch.bfloat16).float()
        for o in (0, cout - 1):
            np.testing.assert_array_equal(blk[o // 4, :, o % 4].numpy(), wb[o].numpy())
        if cout % 4:
            assert (blk[-1, :, cout % 4 :] == 0).all()
        off += g * 4 * cin
    np.testing.assert_array_equal(
        pw.flat[off:].numpy(), torch.cat([b for _, b in pw.layers]).numpy()
    )


def test_wrapper_runs_plain_on_cpu_without_launching(form_a):
    before = ps.fused_point_stages.launches
    a, rgb = ps.fused_point_stages(*form_a["args"])
    a_p, rgb_p = ps.point_stages_plain(*form_a["args"])
    assert ps.fused_point_stages.launches == before
    np.testing.assert_array_equal(a.numpy(), a_p.numpy())
    np.testing.assert_array_equal(rgb.numpy(), rgb_p.numpy())


def test_wrapper_has_no_fallback():
    """Non-CPU, non-CUDA tensors raise; the CUDA path launches or raises
    (no try/except around the build or the launch)."""
    for fn in (ps.fused_point_stages, ps._launch, ps.load_library):
        src = inspect.getsource(fn)
        assert "except" not in src and "try:" not in src
    meta = torch.empty(3 * 4, 140, dtype=torch.int8, device="meta")
    with pytest.raises(ValueError):
        ps.fused_point_stages(meta, None, None, (), None, None, None)
