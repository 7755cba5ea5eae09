"""The progressive renderer under the geometry-table switches whose fused
path does not lerp its geometry tables in the kernel's own layouts, against
the JAX package's `render_demo_fn` at 128^2 with the trained checkpoint
(the pattern and bounds of tests/test_torch_geom_layouts.py): the lerp-axes
level-1 table (`l1_nearest` 11), the int4 coarse table and the word-packed
tables (queried into a (P, 96) or (P, 128) feature), the dense-convolution
stack (`dense_conv`, the default tables from dense volumes), the float
tables of `quantize_volume` off, and the occupancy cull read from a
nearest level-1 table (`l1_nearest` 1 with `sigma_query_cull`)."""

import pytest

from test_torch_geom_layouts import (  # noqa: F401 (few_torch_threads: autouse fixture)
    assert_matches_jax,
    few_torch_threads,
    jax_render,
    jax_variables,
    load_batch,
    port_render,
)

CASES = {
    "l1_nearest 11": (dict(l1_nearest=11), "feats96"),
    "int4_coarse": (dict(int4_coarse=True), "feats96"),
    "pack_octet_u32": (dict(pack_octet_u32=True), "feats128"),
    "dense_conv": (dict(dense_conv=True), "default"),
    "quantize_volume off": (dict(quantize_volume=False), "float32"),
    "l1_nearest 1, sigma_query_cull": (dict(l1_nearest=1, sigma_query_cull=True), "l1-nearest"),
}


@pytest.fixture(scope="module")
def batch():
    return load_batch()


@pytest.fixture(scope="module")
def jax_renders(batch):
    cache, variables = {}, jax_variables(batch)

    def get(case):
        if case not in cache:
            cache[case] = jax_render(batch, variables, CASES[case][0])
        return cache[case]

    return get


@pytest.mark.parametrize("case", sorted(c for c in CASES if c != "quantize_volume off"))
def test_layout_matches_jax(case, batch, jax_renders):
    tpu, layout = CASES[case]
    assert_matches_jax(port_render(batch, tpu, layout), jax_renders(case))


def test_float_tables_match_jax(batch, jax_renders):
    """quantize_volume off: float32 octet tables with unit scales, the
    kernel rounding their rows to bf16 where JAX's op-by-op query lerps
    float32."""
    tpu, layout = CASES["quantize_volume off"]
    med, mx, psnr = assert_matches_jax(port_render(batch, tpu, layout),
                                       jax_renders("quantize_volume off"), median_tol=1e-3,
                                       max_tol=0.1)
    print(f"quantize_volume off vs JAX: |d| median {med:.2e} max {mx:.4f}, {psnr:.2f} dB")


def test_lerp_axes_opbyop_matches_jax(batch, jax_renders):
    """The op-by-op point stages on the lerp-axes level-1 table."""
    tpu, _ = CASES["l1_nearest 11"]
    assert_matches_jax(port_render(batch, tpu, pallas_point=False), jax_renders("l1_nearest 11"))
