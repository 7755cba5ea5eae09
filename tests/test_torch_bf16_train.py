"""bf16 mixed-precision training (`tpu.train_dtype bfloat16`) of the port
against the JAX package's, at the size of tests/test_bf16_train.py (tiny
encoder, 128^2, code_dim 16, 256 rays x 8 samples).

Both packages start from the same variables (the port's seeded init, read
into a zero tree of the JAX package's variable shapes and carried back
through `from_jax_variables`), the same batch and the same stratified
sampling draws. The JAX package's bf16 semantics (render/base.py:500-507):
float32 master parameters; the encoder's convolutions, the sparse stack's
row convolutions (input and weight cast before the gather, float32 sums)
and every Dense layer of the heads compute in bf16, each Dense's bf16
output feeding the next; the norms, the attention fusion and the
compositing stay float32. The port computes on real bf16 tensors there
(models/layers.py).

Why the gradient is held stage by stage. At this size and random init the
whole step's gradient amplifies any rounding detail: the JAX package's own
bf16 gradient moves by 43% (relative L2) between two XLA compilations of
the same step (excess precision allowed or not), about as far as bf16 lies
from float32 (45%), because the cotangent reaching the encoder passes back
through the heads and fourteen train-mode BatchNorms whose backward
cancels. So each stage's vector-Jacobian product is taken on the same
inputs and the same seeded cotangent in both packages, where the bf16
semantics decide the result: the encoder (its parameters, from the source
images and a cotangent on the features), the sparse stack with the code
fusion (its parameters, from the vertex features and cotangents on the four
level matrices, train-mode BatchNorms) and the heads (their parameters and
the level matrices, from the frame's sample points, projected features
and a cotangent on `raw`). The JAX reference is compiled with XLA's excess
precision off, so every bf16 cast of the package's code rounds, as it does
op by op.

Held:
  * the loss against JAX's bf16 loss within 1e-2 relative (measured
    4.5e-3; JAX's float32 loss lies 5.4e-3 from it);
  * each stage: the port's bf16 gradient nearer JAX's bf16 gradient than
    JAX's own float32 gradient is, in cosine and in relative L2;
  * the whole step's gradient within the JAX package's catastrophic-
    breakage bounds (tests/test_bf16_train.py: norm ratio within (0.2,
    5), cosine > 0.2) of JAX's bf16 gradient, and of the port's float32
    step, whose loss it holds within 50%;
  * after the AdamW step every parameter, gradient and optimizer state
    float32, the parameters moved;
  * in one forward pass, the convolutions of the encoder and the products
    of the heads' Linear layers take bf16 operands, the sparse stack's row
    convolutions gather bf16 rows, and the BatchNorms and InstanceNorms
    return float32.

Measured (this size, CPU): loss 0.108750 against JAX's 0.109235; stage
gradients, port against JAX bf16 beside JAX float32 against JAX bf16 (rel
L2): encoder 0.053 / 0.116, sparse stack 0.087 / 0.153, heads 0.0097 /
0.024. A row convolution whose bf16 product also rounded its result would
put the sparse stack at 0.168, beyond float32's."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.render.base import src_norm as jax_src_norm
from gpnerf_tpu.train.checkpoint import unpack_state
from gpnerf_tpu.train.step import merge_variables, split_variables
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.models.layers import InstanceNorm, MaskedBatchNorm, MLP, ReflectConv
from gpnerf_tpu_torch.ops.projection import project_and_gather
from gpnerf_tpu_torch.ops.rays import sample_points, sample_z_vals
from gpnerf_tpu_torch.render.base import (
    batch_to_device,
    build_render,
    points_to_dhw_vox,
    prepare_frame,
    src_norm,
)
from gpnerf_tpu_torch.train.checkpoint import from_jax_variables
from gpnerf_tpu_torch.train.criterion import Criterion
from gpnerf_tpu_torch.train.step import make_optimizer, train_step

ROOT = os.path.join(os.path.dirname(__file__), "..")


def small_cfg(base, train_dtype):
    cfg = base.clone()
    cfg.defrost()
    cfg.merge_from_file(os.path.join(ROOT, "configs", "synthetic.yaml"))
    cfg.encoder.name = "tiny"
    cfg.dataset.H = 128
    cfg.dataset.W = 128
    cfg.head.sigma.code_dim = 16
    cfg.train.n_rays = 256
    cfg.train.n_samples = 8
    cfg.tpu.eval_ray_cap = 4096
    cfg.tpu.eval_chunk = 1024
    cfg.tpu.train_dtype = train_dtype
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class OpDtypes(TorchDispatchMode):
    """Records (innermost hooked module, op, operand dtypes) of every
    convolution and matrix product dispatched inside a hooked module."""

    OPS = ("convolution", "mm", "bmm", "addmm", "index_select")

    def __init__(self):
        super().__init__()
        self.stack, self.seen = [], []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if self.stack and name in self.OPS:
            dts = tuple(a.dtype for a in args if isinstance(a, torch.Tensor))
            self.seen.append((self.stack[-1], name, dts))
        return func(*args, **(kwargs or {}))


def hooked_forward(render, batch, t_rand):
    """One training forward of `render` with forward hooks on its layers:
    returns the OpDtypes records and {norm module: (input dtype, output
    dtype)}."""
    mode, norms, handles = OpDtypes(), {}, []

    def enter(name):
        return lambda mod, args: mode.stack.append(name) and None

    def leave(mod, args, out):
        mode.stack.pop()

    def norm_dtypes(name):
        return lambda mod, args, out: norms.setdefault(name, (args[0].dtype, out.dtype)) and None

    for name, m in render.named_modules():
        if isinstance(m, (ReflectConv, MLP)):
            handles.append(m.register_forward_pre_hook(enter(name)))
            handles.append(m.register_forward_hook(leave))
        if isinstance(m, (InstanceNorm, MaskedBatchNorm)):
            handles.append(m.register_forward_hook(norm_dtypes(name)))
    # the sparse stack runs through `features`, not `forward`
    net = render.nerfhead.sigmahead.xyzc_net
    features = net.features

    def traced(*a, **kw):
        mode.stack.append("nerfhead.sigmahead.xyzc_net")
        try:
            return features(*a, **kw)
        finally:
            mode.stack.pop()

    net.features = traced
    try:
        with mode:
            render.render_train(batch, t_rand=t_rand)
    finally:
        del net.features
        for h in handles:
            h.remove()
    return mode.seen, norms


COMPILE = {"xla_allow_excess_precision": False}


def _compiled(fn, *args):
    """`fn` jitted and compiled with every bf16 cast rounding (COMPILE)."""
    return jax.jit(fn).lower(*args).compile(compiler_options=COMPILE)


@pytest.fixture(scope="module")
def frame():
    """Configs, the batch, the carried variables and the sampling draws."""
    jc = {dt: small_cfg(jax_cfg, dt) for dt in ("float32", "bfloat16")}
    pc = {dt: small_cfg(port_cfg, dt) for dt in ("float32", "bfloat16")}
    random.seed(0)
    np.random.seed(0)
    b = jax_get("dataset", jc["float32"].dataset.train.file)(jc["float32"], is_train=True)[0]
    torch.manual_seed(0)
    seeded = build_render(pc["float32"], device="cpu").init_variables(0).state_dict()
    jr = {dt: jax_get("render", "BaseRender")(c) for dt, c in jc.items()}
    shapes = jax.eval_shape(lambda: jr["float32"].init_variables(0, b))
    zeros = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    variables = jax.tree.map(np.asarray, unpack_state(seeded, zeros, 4))
    rng = jax.random.PRNGKey(1)
    t_rand = np.array(jax.random.uniform(rng, (256, 8)))
    return {"jc": jc, "pc": pc, "b": b, "jb": {k: jnp.asarray(v) for k, v in b.items()},
            "pb": batch_to_device(b, "cpu"), "jr": jr, "variables": variables,
            "state": from_jax_variables(variables), "rng": rng, "t_rand": torch.from_numpy(t_rand)}


def _port_render(f, dt):
    r = build_render(f["pc"][dt], device="cpu")
    r.load_state_dict(f["state"], strict=True)
    return r


@pytest.fixture(scope="module")
def runs(frame):
    """JAX: the bf16 step's loss and gradient; the port: one bf16 and one
    float32 `train_step` and one hooked bf16 forward, from the same
    variables and draws."""
    f = frame
    params, bstats = split_variables(f["variables"])
    crit = jax_get("criterion", f["jc"]["float32"].train.criterion_file)(f["jc"]["float32"])
    r16, jb = f["jr"]["bfloat16"], f["jb"]

    def loss_fn(p):
        ret, _ = r16.render_train(merge_variables(p, bstats), jb, f["rng"])
        return sum(crit(ret, jb).values())

    loss, grads = _compiled(jax.value_and_grad(loss_fn), params)(params)
    out = {"jax": (float(loss), from_jax_variables(jax.tree.map(np.asarray, grads))), "port": {}}
    for dt in ("float32", "bfloat16"):
        render = _port_render(f, dt)
        opt, sched, _ = make_optimizer(render, f["pc"][dt])
        m, _ = train_step(render, Criterion(f["pc"][dt]), opt, sched, f["pb"], t_rand=f["t_rand"])
        out["port"][dt] = (float(m["loss"]), {k: p.grad.clone() for k, p in render.named_parameters()})
    out.update(render=render, opt=opt)
    out["seen"], out["norms"] = hooked_forward(_port_render(f, "bfloat16"), f["pb"], f["t_rand"])
    return out


def _flat(grads, keys):
    return np.concatenate([np.asarray(grads[k], np.float64).ravel() for k in keys])


def _cos(a, b):
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _stage_encoder(f, dt):
    """The encoder's parameter gradient of <features, seeded cotangent>."""
    ct = np.random.default_rng(1).standard_normal((3, 32, 32, 32)).astype(np.float32)
    if dt is None:  # the port, bf16
        r = _port_render(f, "bfloat16")
        (r.encoder(src_norm(f["pb"]["src_imgs"])).float() * torch.from_numpy(ct)).sum().backward()
        return {k: p.grad for k, p in r.encoder.named_parameters()}
    jr = f["jr"][dt]
    x = jax_src_norm(f["jb"]["src_imgs"])
    p0 = f["variables"]["encoder"]["params"]
    g = _compiled(jax.grad(lambda p: jnp.sum(jr.encoder.apply({"params": p}, x).astype(jnp.float32)
                                              * ct)), p0)(p0)
    state = from_jax_variables({"encoder": jax.tree.map(np.asarray, g),
                                "head": f["variables"]["head"]["params"]})
    return {k[len("encoder."):]: v for k, v in state.items() if k.startswith("encoder.")}


def _sparse_inputs(f):
    """The vertex features of the float32 encoder and the level tables."""
    jr = f["jr"]["float32"]
    fm = jr.encoder.apply(f["variables"]["encoder"], jax_src_norm(f["jb"]["src_imgs"]))
    return jr.prepare_frame(f["jb"], fm)


def _stage_sparse(f, dt, pre):
    """The code fusion's and the sparse stack's parameter gradient of the
    level matrices against seeded cotangents, train-mode BatchNorms."""
    rng = np.random.default_rng(2)
    cts = [rng.standard_normal((g.coords.shape[0], 32)).astype(np.float32) for g in pre["grids"][1:]]
    smpl_feat = np.asarray(pre["smpl_feat"])
    if dt is None:
        r = _port_render(f, "bfloat16")
        grids = prepare_frame(f["pb"], torch.zeros(3, 32, 32, 32), r.max_out_sh)["grids"]
        feats = r.nerfhead.volume(torch.from_numpy(smpl_feat), f["pb"]["vertex_rows"], grids,
                                  train=True)
        sum((x * torch.from_numpy(c)).sum() for x, c in zip(feats, cts)).backward()
        # the attention's LayerNorm takes part in no output: JAX's gradient is 0
        return {k: torch.zeros_like(p) if p.grad is None else p.grad
                for k, p in r.nerfhead.sigmahead.named_parameters()
                if not k.startswith("out_geometry_fc")}
    jr = f["jr"][dt]
    hv = f["variables"]["head"]

    def loss(p):
        feats, _ = jr.nerfhead.apply({"params": p, "batch_stats": hv["batch_stats"]}, smpl_feat,
                                     pre["vertex_rows"], pre["grids"], train=True, method="volume",
                                     mutable=["batch_stats"])
        return sum(jnp.sum(x.astype(jnp.float32) * c) for x, c in zip(feats, cts))

    g = _compiled(jax.grad(loss), hv["params"])(hv["params"])
    state = from_jax_variables({"encoder": f["variables"]["encoder"]["params"],
                                "head": jax.tree.map(np.asarray, g)})
    pre_ = "nerfhead.sigmahead."
    return {k[len(pre_):]: v for k, v in state.items()
            if k.startswith(pre_) and not k.startswith(pre_ + "out_geometry_fc")}


def _stage_heads(f, dt, pre):
    """The heads' parameter gradient and the level matrices' gradient of
    <raw, seeded cotangent> at the frame's 256 x 8 sample points (the
    float32 stack's level matrices, the projected rgb and features)."""
    jr32 = f["jr"]["float32"]
    hv = f["variables"]["head"]
    feats = [np.asarray(x) for x in jr32.nerfhead.apply(
        hv, pre["smpl_feat"], pre["vertex_rows"], pre["grids"], train=False, method="volume")]
    pb = f["pb"]
    r32 = _port_render(f, "float32")
    with torch.no_grad():
        z = sample_z_vals(pb["near"], pb["far"], 8, perturb=True, t_rand=f["t_rand"])
        pts = sample_points(pb["ray_o"], pb["ray_d"], z)
        dhw = points_to_dhw_vox(pts, pb, r32.voxel_size).numpy()
        fm = r32.encoder(src_norm(pb["src_imgs"]))
        KE = torch.from_numpy(np.asarray(pre["KE"]))
        rgb_feat, mask = project_and_gather(pts.reshape(-1, 3), KE,
                                            src_norm(pb["src_imgs"]) * 0.5 + 0.5, fm, 128, 128)
    rgb_feat = rgb_feat.reshape(256, 8, 3, -1).numpy()
    mask = mask.reshape(256, 8, 3, 1).numpy()
    out_sh = np.asarray(f["b"]["out_sh"]).astype(np.int32)
    ct = np.random.default_rng(3).standard_normal((256, 8, 4)).astype(np.float32)
    if dt is None:
        r = _port_render(f, "bfloat16")
        lf = [torch.from_numpy(x).requires_grad_() for x in feats]
        grids = prepare_frame(pb, torch.zeros(3, 32, 32, 32), r.max_out_sh)["grids"]
        raw, _ = r.nerfhead.point_forward(
            r.sparse_query_ctx(lf, grids), torch.from_numpy(dhw), torch.from_numpy(out_sh),
            torch.from_numpy(rgb_feat), torch.from_numpy(mask))
        (raw.float() * torch.from_numpy(ct)).sum().backward()
        g = {k: p.grad for k, p in r.nerfhead.named_parameters() if p.grad is not None}
        return g, [x.grad for x in lf]
    jr = f["jr"][dt]

    def loss(p, lf):
        ctx = jr.sparse_query_ctx(lf, pre["grids"])
        raw, _ = jr.nerfhead.apply({"params": p, "batch_stats": hv["batch_stats"]}, ctx, dhw,
                                   out_sh, rgb_feat, mask, method="point_forward")
        return jnp.sum(raw.astype(jnp.float32) * ct)

    g, gl = _compiled(jax.grad(loss, argnums=(0, 1)), hv["params"], feats)(hv["params"], feats)
    state = from_jax_variables({"encoder": f["variables"]["encoder"]["params"],
                                "head": jax.tree.map(np.asarray, g)})
    return ({k[len("nerfhead."):]: v for k, v in state.items()
             if k.startswith(("nerfhead.sigmahead.out_geometry_fc", "nerfhead.rgbhead"))},
            [np.asarray(x) for x in gl])


@pytest.fixture(scope="module")
def stages(frame):
    """stage -> {"port", "bfloat16", "float32"}: flat gradient vectors."""
    pre = _sparse_inputs(frame)
    out = {}
    for name, fn in (("encoder", _stage_encoder), ("sparse stack", _stage_sparse),
                     ("heads", _stage_heads)):
        args = () if fn is _stage_encoder else (pre,)
        res = {k: fn(frame, dt, *args) for k, dt in (("port", None), ("bfloat16", "bfloat16"),
                                                     ("float32", "float32"))}
        if name == "heads":
            res = {k: (g, {f"level{i}": x for i, x in enumerate(lv)}) for k, (g, lv) in res.items()}
            res = {k: {**g, **lv} for k, (g, lv) in res.items()}
        keys = sorted(res["bfloat16"])
        assert set(res["port"]) == set(keys), name
        out[name] = {k: _flat(v, keys) for k, v in res.items()}
    return out


def test_bf16_loss_matches_jax(runs):
    lp, lj = runs["port"]["bfloat16"][0], runs["jax"][0]
    print(f"loss: port bf16 {lp:.6f}, JAX bf16 {lj:.6f}")
    assert np.isfinite(lp) and abs(lp - lj) <= 1e-2 * abs(lj), (lp, lj)


@pytest.mark.parametrize("stage", ["encoder", "sparse stack", "heads"])
def test_bf16_stage_gradient_nearer_jax_bf16_than_float32(stages, stage):
    """Cosine and relative L2 of the port's bf16 gradient against JAX's
    bf16 gradient, beside JAX's float32 gradient against the same."""
    g = stages[stage]
    p, j, f32 = g["port"], g["bfloat16"], g["float32"]
    print(f"{stage}: port bf16 cos {_cos(p, j):.6f} rel {_rel(p, j):.3e}; "
          f"JAX float32 cos {_cos(f32, j):.6f} rel {_rel(f32, j):.3e}")
    assert _cos(p, j) > _cos(f32, j) and _rel(p, j) < _rel(f32, j)


def test_bf16_step_gradient_within_breakage_bounds(runs):
    """The whole step: the port's bf16 gradient against JAX's bf16
    gradient and against the port's float32 step, within
    tests/test_bf16_train.py's bounds; the losses within 50%."""
    (l32, g32), (l16, g16) = runs["port"]["float32"], runs["port"]["bfloat16"]
    lj, gj = runs["jax"]
    keys = sorted(gj)
    b, a, j = _flat(g16, keys), _flat(g32, keys), _flat(gj, keys)
    assert np.isfinite(l16) and np.isfinite(b).all()
    assert abs(l16 - l32) < 0.5 * abs(l32) + 1e-4, (l32, l16)
    for ref, what in ((a, "port float32"), (j, "JAX bf16")):
        ratio, cos = np.linalg.norm(b) / np.linalg.norm(ref), _cos(b, ref)
        print(f"whole step against {what}: norm ratio {ratio:.4f}, cos {cos:.4f}, "
              f"rel {_rel(b, ref):.3e}")
        assert 0.2 < ratio < 5.0 and cos > 0.2, (what, ratio, cos)


def test_bf16_step_keeps_float32_state(runs, frame):
    """Float32 master parameters, gradients and AdamW moments after the
    bf16 step; the parameters moved from the carried state."""
    render, opt, state = runs["render"], runs["opt"], frame["state"]
    moved = 0
    for k, p in render.named_parameters():
        assert p.dtype == torch.float32 and p.grad.dtype == torch.float32, k
        st = opt.state[p]
        assert st["exp_avg"].dtype == st["exp_avg_sq"].dtype == torch.float32, k
        moved += not torch.equal(p.detach(), state[k])
    assert moved >= len(list(render.parameters())) - 2
    assert all(v.dtype == torch.float32 for k, v in render.state_dict().items()
               if k.endswith(("running_mean", "running_var")))


def test_bf16_forward_operands(runs):
    """The hooked forward: every encoder convolution takes (bf16 input,
    bf16 weight); every product of the heads' Linear layers takes bf16
    operands; every row convolution of the sparse stack gathers bf16 rows
    and multiplies them widened to float32 (JAX's float32 result:
    ops/sparse_conv.py `_conv_gather_mm`); every MaskedBatchNorm takes and
    returns float32, every InstanceNorm returns float32 (it receives its
    convolution's bf16 output, as in JAX)."""
    seen, norms, render = runs["seen"], runs["norms"], runs["render"]
    convs = {n for n, m in render.named_modules() if isinstance(m, ReflectConv)}
    mlps = {n for n, m in render.named_modules() if isinstance(m, MLP)}
    conv_ops = [s for s in seen if s[1] == "convolution"]
    assert {s[0] for s in conv_ops} == convs and len(conv_ops) == len(convs)
    assert all(s[2][:2] == (torch.bfloat16, torch.bfloat16) for s in conv_ops)
    mlp_ops = [s for s in seen if s[0] in mlps]
    n_linear = sum(isinstance(c, torch.nn.Linear) for n in mlps for c in render.get_submodule(n))
    assert {s[0] for s in mlp_ops} == mlps and len(mlp_ops) == n_linear
    assert all(set(s[2]) == {torch.bfloat16} for s in mlp_ops)
    sparse_ops = [s for s in seen if s[0] == "nerfhead.sigmahead.xyzc_net"]
    gathers = [s for s in sparse_ops if s[1] == "index_select"]
    products = [s for s in sparse_ops if s[1] == "mm"]
    # subm0, then a strided and a double conv per level
    assert len(gathers) == len(products) == 2 + 3 * 4 and len(sparse_ops) == 2 * 14
    assert all(s[2][0] == torch.bfloat16 for s in gathers)
    assert all(set(s[2]) == {torch.float32} for s in products)
    bns = {n for n, m in render.named_modules() if isinstance(m, MaskedBatchNorm)}
    ins = {n for n, m in render.named_modules() if isinstance(m, InstanceNorm)}
    assert bns | ins == set(norms) and len(bns) == 14
    assert all(norms[n] == (torch.float32, torch.float32) for n in bns)
    assert all(norms[n][1] == torch.float32 for n in ins)
    assert any(norms[n][0] == torch.bfloat16 for n in ins)
