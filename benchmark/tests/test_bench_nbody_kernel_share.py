"""The reader `nbody_kernel_point_share` on a hand-built trace: the
program's `nbody_kernel_points` over its `nbody_points`, None where the
program keeps no such counter or did not open one `nbody.render` span in
each traced request."""

import pytest

from benchmark import spans
from benchmark.harness import reader

from test_bench_nbody import _ctx, _events

NAME = "nbody_kernel_point_share"


@pytest.mark.parametrize("counters, want", [
    ({"nbody_points": 9_000_000, "nbody_kernel_points": 9_000_000}, 100.0),
    ({"nbody_points": 8_000_000, "nbody_kernel_points": 2_000_000}, 25.0),
    ({"nbody_points": 9_000_000}, None),
    ({}, None),
    (None, None),
])
def test_reads_the_counters(monkeypatch, counters, want):
    monkeypatch.setattr(spans, "counters", lambda: counters)
    got = reader(NAME)(_ctx(_events()))
    assert got == (pytest.approx(want) if want is not None else None)


def test_none_without_one_render_a_request(monkeypatch):
    monkeypatch.setattr(spans, "counters",
                        lambda: {"nbody_points": 10, "nbody_kernel_points": 10})
    assert reader(NAME)(_ctx(_events(render="gpnerf.render"))) is None
    one_short = [e for e in _events() if e["name"] != "nbody.render" or e["ts"] < 3000]
    assert reader(NAME)(_ctx(one_short)) is None
