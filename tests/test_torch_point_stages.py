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
from point_tables import seeded_tables

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


def _unpack_kernel_layout(pw):
    """The (pad16(Cout), pad16(Cin)) bf16 blocks and float32 biases of the
    byte buffer the CUDA kernel stages in shared memory, read back."""
    blocks, off = [], 0
    for w, _ in pw.layers:
        n = ps.pad16(w.shape[0]) * ps.pad16(w.shape[1]) * 2
        blocks.append(pw.flat[off : off + n].view(torch.bfloat16)
                      .reshape(ps.pad16(w.shape[0]), ps.pad16(w.shape[1])))
        off += n
    return blocks, pw.flat[off:].view(torch.float32)


def test_kernel_weight_layout(form_a):
    """The byte buffer the CUDA kernel stages in shared memory: per layer
    the bf16-rounded (Cout, Cin) weight zero-padded to multiples of 16,
    row-major, then all float32 biases; 33,280 bf16 values and 388 biases
    (68,112 bytes) for C = 35."""
    pw = form_a["args"][-1]
    assert pw.flat.dtype == torch.uint8 and pw.flat.shape == (33280 * 2 + 388 * 4,)
    blocks, biases = _unpack_kernel_layout(pw)
    assert sum(b.numel() for b in blocks) == 33280
    for (w, _), blk in zip(pw.layers, blocks):
        cout, cin = w.shape
        assert blk.shape[0] % 16 == 0 and blk.shape[1] % 16 == 0
        assert blk.shape[0] - cout < 16 and blk.shape[1] - cin < 16
        np.testing.assert_array_equal(blk[:cout, :cin].float().numpy(),
                                      w.to(torch.bfloat16).float().numpy())
        assert (blk[cout:].float() == 0).all() and (blk[:, cin:].float() == 0).all()
    np.testing.assert_array_equal(biases.numpy(),
                                  torch.cat([b for _, b in pw.layers]).numpy())


def _tile_walk(blk, bias, x):
    """The kernel's walk of one layer: A = bf16(x) zero-padded to (pad16(P),
    Kp); per 16-row M tile and 16-wide N tile a float32 accumulator summed
    over the 16-deep K tiles of exact bf16 products, then the bias."""
    P, cin = x.shape
    Np, Kp = blk.shape
    a = torch.zeros(ps.pad16(P), Kp)
    a[:P, :cin] = x.to(torch.bfloat16).float()
    wt = blk.float().T  # matrix_b: B[k][n] = W[n][k]
    out = torch.empty(ps.pad16(P), Np)
    for m in range(0, a.shape[0], 16):
        for n in range(0, Np, 16):
            acc = torch.zeros(16, 16)
            for k in range(0, Kp, 16):
                acc += a[m : m + 16, k : k + 16] @ wt[k : k + 16, n : n + 16]
            out[m : m + 16, n : n + 16] = acc
    return out[:P, : bias.shape[0]] + bias


def test_kernel_tile_walk_matches_dense(form_a):
    """Walking the packed buffer in 16 x 16 x 16 tiles, as the CUDA kernel's
    WMMA loop does, reproduces `_dense` for all 12 layers on seeded inputs
    (ragged P, inputs at the scale the layers see); only the order of the
    float32 sums differs."""
    pw = form_a["args"][-1]
    blocks, biases = _unpack_kernel_layout(pw)
    rs = np.random.RandomState(6)
    off = 0
    for i, ((w, b), blk) in enumerate(zip(pw.layers, blocks)):
        cout, cin = w.shape
        x = torch.from_numpy((rs.randn(37, cin) * 3).astype(np.float32))
        got = _tile_walk(blk, biases[off : off + cout], x)
        want = ps._dense((w, b), x)
        # float32 sums of up to 144 products of magnitude <= ~30 in another order
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-4,
                                   err_msg=f"layer {i}")
        off += cout
    assert off == biases.numel()


def test_wrapper_runs_plain_on_cpu_without_launching():
    """The entry on CPU tensors (form (a) on the seeded tables of
    tests/point_tables.py) runs its plain version and launches nothing."""
    args, kw = seeded_tables(ps.Key(("i8",), "default", False))
    before = sum(ps.LAUNCHES.values())
    a, rgb = ps.fused_point_stages_from_tables(*args, **kw)
    a_p, rgb_p = ps.point_stages_from_tables_plain(*args, **kw)
    assert sum(ps.LAUNCHES.values()) == before
    np.testing.assert_array_equal(a.numpy(), a_p.numpy())
    np.testing.assert_array_equal(rgb.numpy(), rgb_p.numpy())


def test_wrapper_has_no_fallback():
    """Non-CPU, non-CUDA tensors raise; the CUDA path launches or raises
    (no try/except around the build or the launch)."""
    for fn in (ps.fused_point_stages_from_tables, ps._launch_from_tables, ps._run,
               ps.load_library, ps.start_build):
        src = inspect.getsource(fn)
        assert "except" not in src and "try:" not in src
    meta = torch.empty(64, 3, device="meta")
    with pytest.raises(ValueError):
        ps.fused_point_stages_from_tables((), meta, None, (48, 64), None, None)
