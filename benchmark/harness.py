"""One run of one cell: set-up, the measured (or traced) window, the
reference's check, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its metrics come from BENCHMARK.json at the
root of the checkout; the configuration's file, the traffic file
(benchmark/traffic/<traffic>.json) and each per-layer metric's reader
(benchmark/metrics/<metric>.py) are found by name, and the configuration
names the program each loop runs and the reference that checks it
(benchmark/system.py). With `--trace 0` the line's metrics are the cell's
end-to-end metrics; with `--trace 1` the loop runs one traced stretch (the
traffic file's `trace_seconds`) under the profiler and the line's metrics
are the cell's per-layer metrics. Both decide `correct` the same way
(benchmark/check.py).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "gpnerf_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """BENCHMARK.json and the files of one cell."""

    def __init__(self, workload, root=ROOT):
        self.bench = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
        self.cell = cells[workload]
        confs = {c["name"]: c for c in self.bench["configs"]}
        self.conf = load_json(os.path.join(root, confs[self.cell["config"]]["file"]))
        self.traffic = load_json(os.path.join(BENCH, "traffic", f"{self.cell['traffic']}.json"))

    def _applies(self, metric, e2e_names):
        if "workloads" in metric:
            return self.cell["name"] in metric["workloads"]
        return metric.get("moves", metric["name"]) in e2e_names

    def end_to_end(self):
        names = {m["name"] for m in self.bench["end_to_end"] if "workloads" not in m
                 or self.cell["name"] in m["workloads"]}
        return [m for m in self.bench["end_to_end"] if m["name"] in names]

    def per_layer(self):
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"] if self._applies(m, e2e)]


def reader(name):
    """The `read(ctx)` of benchmark/metrics/<name>.py."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{name}", os.path.join(BENCH, "metrics", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_line():
    """`name, power limit` of the card, from nvidia-smi (None without it)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 else None
    except (OSError, IndexError, subprocess.TimeoutExpired):
        return None


def forbidden_modules():
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


class Context:
    """What a per-layer reader reads: the trace, the window, the cell's
    configuration, the card, and the reference's readings."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


def main(argv=None, *, t0=None, need_cuda=True, overrides=None, root=ROOT):
    """One run; `root` is the directory that holds BENCHMARK.json (paths in
    it are from there)."""
    t0 = time.perf_counter() if t0 is None else t0
    args = parse(argv)
    spec = Spec(args.workload, root)
    conf, traffic = spec.conf, dict(spec.traffic)
    if overrides:
        conf = overrides(conf, traffic)

    import torch

    from benchmark import check, loops, pool, system
    from benchmark.trace import traced

    reference = system.reference(conf)

    chips = spec.cell["chips"]
    if need_cuda:
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"run.py: the cell needs {chips} CUDA device(s); "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    system.float32_without_tf32()
    torch.set_num_threads(traffic.get("threads", 4))

    loop = loops.LOOPS[traffic["loop"]](conf, traffic, args.seed, device)
    loop.setup()
    setup_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.trace:
        w, tr = traced(lambda: loop.window(traffic["trace_seconds"], spans=True), loop.unit)
    else:
        w, tr = loop.window(args.seconds), None
    peak_bytes = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    e2e = loop.end_to_end(w)

    # the check: the reference, once the program's state is freed
    limits = conf["limits"][traffic["loop"]]
    ref_ctx = {}
    if traffic["loop"] == "views":
        served = sorted(set(w["items"]))
        if args.trace:
            items = served
        else:
            k = min(traffic["check_items"], len(served))
            items = sorted(int(i) for i in pool.rng_for(args.seed, 5).choice(served, k, False))
        prog = loop.answers(items)
        attempted = len(w["latencies"])
        loop.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference.render_items(conf, loop.scene, loop.poses, loop.cams,
                                     args.seed, items, device)
        numbers = check.view_numbers(prog, ref)
        ref_ctx = {"ref": ref, "items": w["items"]}
    else:
        attempted = w["steps"] + traffic["check_steps"]
        prog = loop.readings
        t_rands = loop.jitter[:traffic["check_steps"]]
        loop.release()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        ref = reference.train_readings(conf, loop.scene, loop.poses, loop.cams,
                                       args.seed, t_rands, device)
        numbers = check.train_numbers(prog, ref)
        if args.trace:
            ref_ctx = {"sites": reference.train_sites(conf, loop.scene, loop.poses,
                                                      loop.cams, args.seed, len(loop.poses))}
    correct, rows = check.judge(numbers, limits)

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    metrics = {}
    if args.trace:
        ctx = Context(trace=tr, window=w, conf=conf, traffic=traffic, cell=spec.cell,
                      device_name=name, **ref_ctx)
        for m in spec.per_layer():
            v = reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = dict(e2e, setup_s=setup_s)
        for m in spec.end_to_end():
            metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}

    bad = forbidden_modules()
    if bad:
        print(f"run.py: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    device_rec = {"platform": "gpu" if device.type == "cuda" else "cpu", "kind": name,
                  "count": chips, "memory_peak_bytes": int(peak_bytes)}
    if tr is not None:
        device_rec.update(busy_s=tr.busy_s, window_s=tr.window_s)
    line = {"correct": correct, "attempted": int(attempted), "failed": 0,
            "metrics": metrics, "device": device_rec}
    if tr is not None:
        line["breakdown"] = {"device_ops": tr.device_ops, "idle_gaps": tr.idle_gaps}
    line["card"] = card_line() if device.type == "cuda" else None
    line["check"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v, lim in rows:
        print(f"check {k} {v!r} limit {lim!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0
