"""The readings that a cell's limits are set from, in one process on the
card: the numbers of benchmark/check.py for the program over many seeds
(the lower readings), for the control (the reference one precision step
down, benchmark/reference/build.py) and, for training, for a program with
half of each batch left out (the upper readings).

    python3 benchmark/calibrate.py --workload <cell> --seeds <n> ... [--control-seeds <n> ...]

Views: each seed's checked requests, drawn as a run draws them, rendered
through `render_demo_fn()` after a warm request. Training: each seed's
first steps through the training step a run drives. One JSON line per
seed and side on standard output, then a summary line with the largest
program reading and the smallest control and fault readings of each
number. The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def view_readings(spec, seeds, control_seeds, device):
    """{side: {seed: numbers}} for the program and the control."""
    import torch

    from gpnerf_tpu_torch.render.demo import pred_img_hwc

    from benchmark import check, pool, system

    conf, traffic = spec.conf, spec.traffic
    cfg = conf["cfg"]
    tasks = system.reference(conf)
    system.float32_without_tf32()
    render = system.views_program(conf, device)
    fn = render.render_demo_fn()
    out = {"program": {}, "control": {}}
    for seed in seeds:
        scene = pool.new_scene(cfg)
        poses, cams = pool.view_items(seed, traffic["pool"], pool.img_hw(cfg))
        items = sorted(int(i) for i in pool.rng_for(seed, 5).choice(
            traffic["pool"], traffic["check_items"], False))
        ds = pool.make_dataset(system.data_layer(), scene, poses, cams, "test", cfg)
        prog = {}
        for i in items:
            batch = pool.build_batches(ds, seed, [i], pool.VIEW_TAG)[0]
            prog[i] = pred_img_hwc(fn(system.to_device(batch, device)))
        ref = tasks.render_items(conf, scene, poses, cams, seed, items, device)
        out["program"][seed] = check.view_numbers(prog, ref)
        emit("program", seed, out["program"][seed])
        if seed in control_seeds:
            ctl = tasks.render_items(conf, scene, poses, cams, seed, items,
                                     device, control=True)
            out["control"][seed] = check.view_numbers({i: c["image"] for i, c in ctl.items()},
                                                      ref)
            emit("control", seed, out["control"][seed])
        torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def half_batch():
    """The criterion that the train step built, whatever its class, over
    the first half of each batch's rays only: the rest marked invalid in
    `ray_valid`, which the data layer gives every batch, so the mean is
    taken over the first half."""
    from benchmark import system

    init = system.TrainStep.__init__

    def halved(self, *args, **kw):
        init(self, *args, **kw)
        whole = self.criterion

        def half(ret, batch, *a, **k):
            n = batch["ray_valid"].shape[0] // 2
            cut = dict(batch, ray_valid=batch["ray_valid"].clone())
            cut["ray_valid"][n:] = 0
            return whole(ret, cut, *a, **k)

        self.criterion = half

    system.TrainStep.__init__ = halved
    try:
        yield
    finally:
        system.TrainStep.__init__ = init


def train_readings(spec, seeds, control_seeds, device):
    from benchmark import check, loops, system

    system.float32_without_tf32()
    tasks = system.reference(spec.conf)
    conf, traffic = spec.conf, dict(spec.traffic, batches=spec.traffic["check_steps"])
    out = {"program": {}, "control": {}, "half_batch": {}}
    for seed in seeds:
        run = loops.TrainSteps(conf, traffic, seed, device)
        run.setup()
        prog, jitter = run.readings, run.jitter
        run.release()
        args = (conf, run.scene, run.poses, run.cams, seed, jitter, device)
        ref = tasks.train_readings(*args)
        out["program"][seed] = check.train_numbers(prog, ref)
        emit("program", seed, out["program"][seed])
        if seed in control_seeds:
            out["control"][seed] = check.train_numbers(tasks.train_readings(*args, control=True),
                                                       ref)
            emit("control", seed, out["control"][seed])
            with half_batch():
                fault = loops.TrainSteps(conf, traffic, seed, device)
                fault.setup()
            if fault.readings["losses"] == prog["losses"]:
                raise SystemExit(f"{conf['name']}: the half-batch fault moved no loss; "
                                 "the criterion does not weigh rays by `ray_valid`")
            out["half_batch"][seed] = check.train_numbers(fault.readings, ref)
            fault.release()
            emit("half_batch", seed, out["half_batch"][seed])
    return out


def emit(side, seed, numbers):
    print(json.dumps({"side": side, "seed": seed, "numbers": numbers}), flush=True)


def summary(out):
    """The largest program reading and the smallest reading of each other
    side, per number."""
    res = {}
    for side, by_seed in out.items():
        if not by_seed:
            continue
        names = next(iter(by_seed.values())).keys()
        pick = max if side == "program" else min
        res[side] = {k: pick(v[k] for v in by_seed.values()) for k in names}
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = p.parse_args(argv)
    import torch

    from benchmark.harness import Spec

    if not torch.cuda.is_available():
        raise SystemExit("calibrate.py: no CUDA device")
    spec = Spec(args.workload)
    device = torch.device("cuda", 0)
    fn = view_readings if spec.traffic["loop"] == "views" else train_readings
    out = fn(spec, args.seeds, set(args.control_seeds), device)
    print(json.dumps({"summary": summary(out)}), flush=True)
    return out


if __name__ == "__main__":
    main()
