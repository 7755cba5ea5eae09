"""The port's bench, bench_torch.py (bench.py's counterpart), on the CPU.

At 128^2 over 2 bench-protocol frames (utils/bench_frames.py) with the
trained checkpoint, in the bench's own config (configs/synthetic.yaml,
`tpu.matmul_dtype bfloat16`) with the fast mode's caps cut to the frame
size (ray_cap 9216 holds the 8,284 rays of the larger frame):

  * `analytic_flops_per_frame` equals bench.py's exactly;
  * `run_mode` on the CPU (`device cpu`, reps=1, scan_cycles=1,
    iso_cycles=1) returns every key bench.py's `run_mode` returns; the
    scan's counters equal the loop's; its overflows and its ray and
    sigma-slot counts equal the JAX package's `render_demo_fn` counters on
    the same frames and weights, and its colored-point count is within
    0.1% of JAX's (the port's kernel rounds dot inputs to bf16 where the
    JAX CPU path sums in another order, tests/test_torch_demo.py; measured
    36 of 52,935 on the first frame); its PSNR and SSIM equal the JAX
    package's Evaluator on the port's own images within 1e-6;
  * the headline guard refuses a scan timed at 1 us, BENCH_r05's mfu of
    40.4, one changed checksum and a share of the HBM roof of 120%, and
    passes the sound record and a share of 40%;
  * `main` under `device cpu` leaves `mfu` and `roofline` out of the fast
    line and says why on stderr;
  * without a card and without `device cpu`, `main` raises naming the key;
  * the record goes to BENCH_MODES_torch.json under the given root, and
    bench.py's BENCH_MODES.json is left as it was;
  * bench_torch.py, utils/roofline.py and tools/roofline_torch.py import
    neither jax, the JAX package nor bench.py.

~90 s alone, most of it the 22 renders of `run_mode` and JAX's compile."""

import ast
import hashlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.demo import pred_img_hwc as jax_pred_img_hwc
from gpnerf_tpu.train.checkpoint import load_eval_model as jax_load
from gpnerf_tpu.train.evaluator import Evaluator as JaxEvaluator
from gpnerf_tpu_torch.registry import get as port_get
from gpnerf_tpu_torch.render.demo import pred_img_hwc
from gpnerf_tpu_torch.train.checkpoint import load_eval_model
from gpnerf_tpu_torch.utils.bench_frames import get_bench_frames

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
import bench  # noqa: E402  (jax only inside bench.main)
import bench_torch  # noqa: E402

CKPT = os.path.join(ROOT, "artifacts", "bench_ckpt.pth")
ARGV = ["dataset.H", "128", "dataset.W", "128", "tpu.ray_cap", "9216",
        "tpu.sigma_cap", "262144", "tpu.rgb_cap", "131072", "device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    """Whole-frame renders under parallel test files (tests/test_torch_opbyop.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    cfg = bench_torch.bench_cfg(ARGV)
    return cfg, get_bench_frames(cfg, 2, cache_root=str(tmp_path_factory.mktemp("frames")),
                                 verbose=False)


@pytest.fixture(scope="module")
def bench_run(frames):
    """(run_mode's record, the loop's render dicts): every call of
    `render_demo_fn()` is kept; with scan_cycles=1 the last two are the
    loop's pass."""
    cfg, host = frames
    render = load_eval_model(CKPT, port_get("render", cfg.render.file)(cfg, device="cpu"))
    demo_fn = render.render_demo_fn()
    calls = []

    def spy(batch):
        calls.append(demo_fn(batch))
        return calls[-1]

    render.render_demo_fn = lambda: spy
    rec = bench_torch.run_mode(render, cfg, reps=1, scan_cycles=1, iso_cycles=1, host=host)
    return rec, calls[-len(host):]


@pytest.fixture(scope="module")
def jax_counters(frames):
    """The JAX package's render_demo_fn on the same frames with the
    checkpoint, loaded into a zero tree of init_variables' shapes."""
    cfg_p, host = frames
    cfg = jax_cfg.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.dataset.H = cfg.dataset.W = 128
    cfg.dataset.ratio = 1.0
    cfg.head.sigma.code_dim = 32
    cfg.render.file = "demo_render"
    cfg.merge_from_list(ARGV[:-2])
    cfg.freeze()
    assert cfg.tpu.matmul_dtype == cfg_p.tpu.matmul_dtype == "bfloat16"
    jr = jax_get("render", "demo_render")(cfg)
    shapes = jax.eval_shape(lambda: jr.init_variables(0, host[0]))
    variables = jax_load(CKPT, jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes), 4)
    fn = jr.render_demo_fn()
    outs = [fn(variables, {k: jnp.asarray(v) for k, v in b.items()}) for b in host]
    return cfg, [{k: np.asarray(o[k]) for k in ("overflows", "counts")} for o in outs]


def _bench_py_run_mode_keys():
    """The keys of the dict bench.py's run_mode returns, read from its source."""
    with open(os.path.join(ROOT, "bench.py")) as f:
        tree = ast.parse(f.read())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == "run_mode")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


@pytest.mark.parametrize("H,W,counts", [
    (512, 512, (24576, 319488, 120000)),
    (512, 512, (51432, 2520000, 1048576)),
    (512, 512, (0, 0, 0)),
    (128, 128, (4982.0, 62647.0, 52935.5)),
    (1024, 512, (1, 2, 3)),
])
def test_flops_equal_bench_py(H, W, counts):
    assert bench_torch.analytic_flops_per_frame(H, W, counts) == bench.analytic_flops_per_frame(
        H, W, counts)
    assert bench_torch.analytic_flops_per_frame(H, W, counts, code_dim=16) == \
        bench.analytic_flops_per_frame(H, W, counts, code_dim=16)


def test_run_mode_returns_bench_py_keys(bench_run):
    rec, _ = bench_run
    keys = _bench_py_run_mode_keys()
    assert len(keys) == 13 and keys <= set(rec), keys - set(rec)
    assert rec["device"] == "cpu" and rec["timer"] == "host clock" and rec["launches"] == {}
    assert len(rec["loop_reps_ms"]) == 1 and rec["ms_per_frame"] > 0
    assert rec["frame_ms_spread"][0] <= rec["frame_ms_spread"][1] <= rec["frame_ms_spread"][2]
    json.dumps(rec)


def test_scan_counters_equal_loop(bench_run):
    rec, _ = bench_run
    scan, loop = rec["scan_frames"], rec["loop_frames"]
    assert scan["overflows"] == loop["overflows"] and scan["counts"] == loop["counts"]
    np.testing.assert_allclose(scan["checksum"], loop["checksum"], rtol=bench_torch.CHECKSUM_RTOL)
    assert loop["counts"][0] != loop["counts"][1]  # two distinct frames


def test_counters_equal_jax(bench_run, jax_counters):
    rec, _ = bench_run
    _, jouts = jax_counters
    for i, j in enumerate(jouts):
        assert rec["loop_frames"]["overflows"][i] == j["overflows"].tolist()
        assert rec["loop_frames"]["counts"][i][:2] == j["counts"][:2].tolist()
        n_j = int(j["counts"][2])
        assert abs(rec["loop_frames"]["counts"][i][2] - n_j) <= 1e-3 * n_j
    assert rec["overflows"] == np.max([j["overflows"] for j in jouts], axis=0).tolist()
    assert rec["counts_max"][:2] == np.max([j["counts"] for j in jouts], axis=0)[:2].tolist()


def test_quality_equals_jax_evaluator(frames, bench_run, jax_counters):
    rec, rets = bench_run
    _, host = frames
    jcfg, _ = jax_counters
    ev = JaxEvaluator(jcfg, "bench")
    for r, b in zip(rets, host):
        img = pred_img_hwc(r)
        assert np.array_equal(jax_pred_img_hwc({"pred_img": img}), img)
        ev.evaluate({"pred_img": img}, b)
    assert abs(rec["psnr"] - float(np.mean(ev.psnr))) <= 1e-6
    assert abs(rec["ssim"] - float(np.mean(ev.ssim))) <= 1e-6


def _forge(rec, what):
    rec = json.loads(json.dumps(rec))
    mfu, pct = 0.01, None
    if what == "scan timed at 1 us":
        rec["ms_per_frame"], rec["fps"] = 1e-3, 1e6
    elif what == "mfu 40.4":
        mfu = 40.4
    elif what == "changed checksum":
        rec["scan_frames"]["checksum"][1] *= 1.0 + 1e-3
    elif what.startswith("pct_hbm_roof"):
        pct = float(what.split()[1])
    return rec, mfu, pct


@pytest.mark.parametrize("what,refused", [
    ("sound", None),
    ("scan timed at 1 us", "below 0.5 x the loop's best"),
    ("mfu 40.4", "mfu 40.4 is above 1"),
    ("changed checksum", "scan frame 1 (frame 1): checksum"),
    ("pct_hbm_roof 120", "pct_hbm_roof 120.0 is above 100"),
    ("pct_hbm_roof 40", None),
])
def test_headline_guard(bench_run, what, refused):
    rec, mfu, pct = _forge(bench_run[0], what)
    reasons = bench_torch.headline_guard(rec, mfu, pct)
    if refused is None:
        assert reasons == []
        bench_torch.refuse_unsound("fast mode", rec, mfu, pct)
    else:
        assert len(reasons) == 1 and refused in reasons[0], reasons
        with pytest.raises(SystemExit, match="fast mode refused"):
            bench_torch.refuse_unsound("fast mode", rec, mfu, pct)


def test_cpu_run_leaves_roofline_out(monkeypatch, tmp_path, capsys):
    """`main` under `device cpu` (the fast mode alone, its 2 frames, one rep
    of each protocol): the fast line has neither `mfu` nor `roofline`, and
    stderr says why."""
    monkeypatch.setattr(bench_torch, "N_FRAMES", 2)
    monkeypatch.setenv("BENCH_REF", "0")
    monkeypatch.setenv("BENCH_NEG", "0")
    run_mode = bench_torch.run_mode
    monkeypatch.setattr(bench_torch, "run_mode", lambda *a, **k: run_mode(
        *a, **{**k, "reps": 1, "scan_cycles": 1, "iso_cycles": 1}))
    monkeypatch.setenv("BENCH_CKPT", CKPT)
    modes = bench_torch.main(ARGV, root=str(tmp_path))
    out, err = capsys.readouterr()
    (line,) = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    assert "roofline" not in line and "mfu" not in line and line["device"] == "cpu"
    assert "roofline" not in modes["fast"]
    assert "# roofline left out: on the CPU" in err and "# mfu left out: on the CPU" in err


def test_main_raises_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device cpu"):
        bench_torch.main([])
    with pytest.raises(RuntimeError, match="device cpu"):
        bench_torch.main(["dataset.H", "128"])


def test_record_goes_to_its_own_file(bench_run, tmp_path):
    theirs = os.path.join(ROOT, "BENCH_MODES.json")
    before = hashlib.sha256(open(theirs, "rb").read()).hexdigest()
    path = bench_torch.write_record({"fast": bench_run[0]}, str(tmp_path))
    assert path == os.path.join(str(tmp_path), "BENCH_MODES_torch.json")
    assert os.listdir(tmp_path) == ["BENCH_MODES_torch.json"]
    with open(path) as f:
        assert json.load(f)["fast"]["loop_frames"] == bench_run[0]["loop_frames"]
    assert hashlib.sha256(open(theirs, "rb").read()).hexdigest() == before


def test_imports_neither_jax_nor_bench_py():
    """bench_torch.py, and the roofline it reports (utils/roofline.py and
    its CLI tools/roofline_torch.py)."""
    for path in ("bench_torch.py", "tools/roofline_torch.py",
                 "gpnerf_tpu_torch/utils/roofline.py"):
        with open(os.path.join(ROOT, path)) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                names.add(node.module)
        tops = {n.split(".")[0] for n in names}
        assert not tops & {"jax", "jaxlib", "flax", "gpnerf_tpu", "bench"}, (path, names)
        assert "torch" in tops, path
        if path != "gpnerf_tpu_torch/utils/roofline.py":
            assert "gpnerf_tpu_torch" in tops, path
