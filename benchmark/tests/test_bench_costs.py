"""The yardstick's frozen arithmetic: the point-stage kernel's bytes at
the shipped frames' sizes (PERF.md's table: 272.6 MB for form (a) at
319,488 points, 3,306.8 MB for form (c) at 3,670,016), the frame's
analytic FLOPs against bench_torch.py's formula it was copied from, and
the peaks."""

import sys

import pytest

from benchmark import costs

from conftest import ROOT


@pytest.mark.parametrize("form,points,mb", [("a", 319488, 272.6), ("c", 3670016, 3306.8)])
def test_point_stage_bytes(form, points, mb):
    b, f = costs.point_stage_cost(form, points)
    assert round(b / 1e6, 1) == mb
    assert f == 108748 * points


def test_point_stage_bound_is_bytes_at_h100_peaks():
    peak_b = costs.peak(costs.H100, "hbm_bytes_per_s")
    peak_f = costs.peak(costs.H100, "bfloat16")
    b, f = costs.point_stage_cost("a", 319488)
    assert b / peak_b > f / peak_f
    assert round(b / peak_b * 1e3, 4) == 0.0814  # PERF.md's bound for kernel 1 (a)


def test_frame_flops_match_the_bench_formula():
    sys.path.insert(0, ROOT)
    import bench_torch

    counts = (16806, 203331, 170448)
    typical = [6890, 15400, 6900, 1900, 500]  # the sites bench_torch.py holds
    want = bench_torch.analytic_flops_per_frame(512, 512, counts)
    assert costs.frame_flops(512, 512, counts[1], counts[2], typical) == pytest.approx(want,
                                                                                       rel=1e-12)


def test_train_step_is_three_forwards():
    sites = [6890, 15400, 6900, 1900, 500]
    fwd = costs.encoder_flops(512, 512) + costs.volume_flops(sites) + costs.point_flops(
        65536, 65536)
    assert costs.train_step_flops(512, 512, 65536, sites) == 3 * fwd


def test_peaks():
    assert costs.peak(costs.H100, "bfloat16") == 989e12
    assert costs.peak(costs.H100, "float32") == 67e12
    assert costs.peak(costs.H100, "hbm_bytes_per_s") == 3.35e12
    assert costs.peak("some other card", "bfloat16") is None
