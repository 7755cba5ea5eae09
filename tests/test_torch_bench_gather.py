"""The port's row-gather plain version and gather microbenchmark
(gpnerf_tpu_torch/ops/row_gather.py, utils/bench_gather.py) on the CPU."""

import numpy as np
import pytest
import torch

from gpnerf_tpu_torch.ops import row_gather as rg
from gpnerf_tpu_torch.utils import bench_gather


@pytest.mark.parametrize("idx_dtype", [np.int32, np.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_row_gather_plain_matches_numpy(dtype, idx_dtype):
    rs = np.random.RandomState(0)
    table = rs.randn(257, 32).astype(np.float32)
    idx = rs.randint(0, 257, size=1001).astype(idx_dtype)
    t = torch.from_numpy(table).to(dtype)
    out = rg.row_gather_plain(t, torch.from_numpy(idx))
    assert out.dtype == dtype and tuple(out.shape) == (1001, 32)
    # a copy of rows: bitwise
    np.testing.assert_array_equal(out.float().numpy(), t.float().numpy()[idx])
    # the CPU wrapper is the plain version and launches nothing
    before = rg.LAUNCHES["row_gather"]
    assert torch.equal(rg.row_gather(t, torch.from_numpy(idx)), out)
    assert rg.LAUNCHES["row_gather"] == before


def test_bench_gather_run_on_cpu_returns_every_measurement():
    n = 4096
    res = bench_gather.run("cpu", n_queries=n)
    keys = {
        "device", "n_queries", "row_gather_f32_ms", "row_gather_f32_gb_s",
        "row_gather_bf16_ms", "index_select_f32_ms", f"scalar_gather_{n // 2}_ms",
        f"scalar_gather_{4 * n}_ms", f"onehot_matmul_{n // 8}_ms", "kernel_launches",
        "kernel_row_gather_ms", "kernel_row_gather_gb_s", "kernel_row_gather_bf16_ms",
    }
    assert set(res) == keys
    assert res["device"] == "cpu" and res["n_queries"] == n
    assert res["kernel_launches"] == 0  # CPU tensors take the plain version
    for k, v in res.items():
        if k.endswith("_ms") or k.endswith("_gb_s"):
            assert np.isfinite(v) and v > 0, k


def test_onehot_gather_equals_bf16_rows():
    rs = np.random.RandomState(1)
    table = torch.from_numpy(rs.randn(300, 8).astype(np.float32))
    idx = torch.from_numpy(rs.randint(0, 300, size=2500))
    out = bench_gather.onehot_gather(table, idx)
    # a one-hot row selects one bf16-rounded table row exactly
    assert torch.equal(out, table.to(torch.bfloat16)[idx].float())
