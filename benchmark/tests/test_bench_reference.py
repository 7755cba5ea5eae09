"""The plain reference (benchmark/reference/) against the port's eager
path on the CPU at 128x128 with small caps: the port in float32, its point
stages op by op, renders each configuration's frames as the reference
does, and takes the same first train step; the reference's copy of the data
layer assembles the port's batches. The port may be imported here; the
reference imports none of it (test_bench_imports.py)."""

import copy

import numpy as np
import pytest
import torch

from benchmark import pool, system
from benchmark.harness import Spec
from benchmark.reference.eager.data.base import HumanNVSDataset as RefDataset

from conftest import SEED, small

CPU = torch.device("cpu")


def cut(cell, **tpu):
    spec = Spec(cell)
    conf, traffic = copy.deepcopy(spec.conf), dict(spec.traffic)
    small(conf, traffic)
    conf["cfg"]["tpu"].update(tpu)
    return conf, traffic


@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views"])
def test_views_batches_equal(cell):
    conf, traffic = cut(cell)
    cfg = conf["cfg"]
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(SEED, 2, pool.img_hw(cfg))
    a = pool.build_batches(pool.make_dataset(system.data_layer(), scene, poses, cams, "test", cfg),
                           SEED, [1], pool.VIEW_TAG)[0]
    b = pool.build_batches(pool.make_dataset(RefDataset, scene, poses, cams, "test", cfg),
                           SEED, [1], pool.VIEW_TAG)[0]
    assert set(a) == set(b)
    for k in a:
        if k in ("near", "far"):  # the port's native slab test against numpy's
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("cell", ["zju-fast-views", "zju-paper-views"])
def test_render_agrees_with_the_port_in_float32(cell):
    conf, traffic = cut(cell, matmul_dtype="float32", pallas_point=False, pallas_lerp=False)
    cfg = conf["cfg"]
    scene = pool.new_scene(cfg)
    poses, cams = pool.view_items(SEED, 2, pool.img_hw(cfg))
    ds = pool.make_dataset(system.data_layer(), scene, poses, cams, "test", cfg)
    render = system.views_program(conf, CPU)
    ref = system.reference(conf).render_items(conf, scene, poses, cams, SEED, [0, 1], CPU)
    for i in (0, 1):
        ret = render.render_demo(system.to_device(
            pool.build_batches(ds, SEED, [i], pool.VIEW_TAG)[0], CPU))
        img = ret["pred_chw"].permute(1, 2, 0).numpy()
        assert [int(v) for v in ret["counts"]] == ref[i]["counts"]
        assert [int(v) for v in ret["overflows"]] == ref[i]["overflows"]
        np.testing.assert_array_equal(ret["mask_at_box"].numpy(), ref[i]["mask"])
        np.testing.assert_allclose(img, ref[i]["image"], atol=2e-5)
        assert ref[i]["counts"][0] > 100 and ref[i]["counts"][1] > 1000


def test_train_steps_agree_with_the_port():
    from benchmark import check, loops

    conf, traffic = cut("zju-train-1024")
    traffic["batches"] = traffic["check_steps"]
    run = loops.TrainSteps(conf, traffic, SEED, CPU)
    run.setup()
    ref = system.reference(conf).train_readings(conf, run.scene, run.poses, run.cams, SEED,
                                                run.jitter, CPU)
    gaps = check.train_numbers(run.readings, ref)
    # float32 on both sides; the batches' near and far differ by the native
    # slab test's rounding
    assert gaps["loss_gap"] < 1e-4 and gaps["grad_gap"] < 1e-3 and gaps["change_gap"] < 1e-2
    assert len(ref["losses"]) == 3 and all(v > 0 for v in ref["losses"])
