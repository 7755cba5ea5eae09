"""One AdamW train step of the port against the JAX package's
`make_train_step`, from the same JAX-initialized variables carried across
(`from_jax_variables`), on the same batch and the same stratified-sampling
draws, at the size of tests/test_bf16_train.py (tiny encoder, 128^2,
code_dim 16, 256 rays x 8 samples), float32.

Compared: the loss and `rgb_map`; every parameter gradient, key by key;
the BatchNorms' running statistics after the step; the parameters after
AdamW.

The gradient reference. In float32 the JAX step's gradients of every
tensor upstream of a train-mode BatchNorm are 0.45-0.8% (relative L2) off
the exact gradient: its BatchNorm statistics sum ~10^4 rows in float32,
and the gradient through them cancels. Running the same JAX function with
those statistics (and only those) in float64 brings the JAX sparse stack
to 3e-7 of a fully float64 evaluation, which the port's float64 run
matches to 1e-15. The port computes its statistics in float64 too. So the
gradients are held, at 1e-3 relative L2, against the JAX package's train
loss differentiated with `MaskedBatchNorm` swapped for a subclass that
takes its statistics in float64; everything else is the package's code.
The AdamW step itself is held against the unmodified float32
`make_train_step`."""

import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

import gpnerf_tpu.models.encoder as jax_encoder
import gpnerf_tpu.models.sparse_net as jax_sparse_net
from gpnerf_tpu.config import cfg as jax_cfg
from gpnerf_tpu.models.layers import InstanceNorm as JaxIN
from gpnerf_tpu.models.layers import MaskedBatchNorm as JaxBN
from gpnerf_tpu.registry import get as jax_get
from gpnerf_tpu.train.step import make_optimizer as jax_make_optimizer
from gpnerf_tpu.train.step import make_train_step, merge_variables, split_variables
from gpnerf_tpu_torch.config import cfg as port_cfg
from gpnerf_tpu_torch.render.base import batch_to_device, build_render
from gpnerf_tpu_torch.train.checkpoint import from_jax_variables
from gpnerf_tpu_torch.train.criterion import Criterion
from gpnerf_tpu_torch.train.step import make_optimizer, train_step

ROOT = os.path.join(os.path.dirname(__file__), "..")
# conv biases followed by an InstanceNorm (which removes them): their exact
# gradient is 0 and both sides hold rounding noise; the attention's
# LayerNorm takes part in no output
ZERO_GRAD = (
    "encoder.upconv3.conv.conv.bias", "encoder.iconv3.conv.bias",
    "encoder.upconv2.conv.conv.bias", "encoder.iconv2.conv.bias",
    "nerfhead.sigmahead.xyzc_attn.layer_norm.weight",
    "nerfhead.sigmahead.xyzc_attn.layer_norm.bias",
)


def small_cfg(base):
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
    cfg.freeze()
    return cfg


@pytest.fixture(scope="module", autouse=True)
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


class F64StatsBN(JaxBN):
    """The package's MaskedBatchNorm with the statistics and the affine map
    of its train branch in float64 (the same formulas)."""

    @nn.compact
    def __call__(self, x, valid, *, use_running_average: bool):
        C = x.shape[-1]
        scale = self.param("scale", nn.initializers.ones, (C,))
        bias = self.param("bias", nn.initializers.zeros, (C,))
        self.variable("batch_stats", "mean", lambda: jnp.zeros((C,)))
        self.variable("batch_stats", "var", lambda: jnp.ones((C,)))
        assert not use_running_average
        x64 = x.astype(jnp.float64)
        vf = valid.astype(jnp.float64)[:, None]
        n = jnp.maximum(vf.sum(), 1.0)
        mean = (x64 * vf).sum(axis=0) / n
        var = (((x64 - mean) ** 2) * vf).sum(axis=0) / n
        y = (x64 - mean) / jnp.sqrt(var + self.epsilon)
        return (y * scale.astype(jnp.float64) + bias.astype(jnp.float64)).astype(x.dtype)


class F64StatsIN(JaxIN):
    """The package's InstanceNorm with its statistics and affine map in
    float64 (the same formulas)."""

    @nn.compact
    def __call__(self, x):
        C = x.shape[-1]
        x64 = x.astype(jnp.float64)
        mean = jnp.mean(x64, axis=(1, 2), keepdims=True)
        var = jnp.var(x64, axis=(1, 2), keepdims=True)
        y = (x64 - mean) * jax.lax.rsqrt(var + self.epsilon)
        scale = self.param("scale", nn.initializers.ones, (C,))
        bias = self.param("bias", nn.initializers.zeros, (C,))
        return (y * scale.astype(jnp.float64) + bias.astype(jnp.float64)).astype(jnp.float32)


@pytest.fixture(scope="module")
def step():
    """JAX: the float32 step and the float64-statistics gradient; the port:
    one `train_step` from the carried variables."""
    jc, pc = small_cfg(jax_cfg), small_cfg(port_cfg)
    random.seed(0)
    np.random.seed(0)
    b = jax_get("dataset", jc.dataset.train.file)(jc, is_train=True)[0]
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jr = jax_get("render", "BaseRender")(jc)
    variables = jax.tree.map(np.asarray, jax.jit(jr._init_variables_impl)(jax.random.PRNGKey(0), jb))
    crit = jax_get("criterion", jc.train.criterion_file)(jc)
    params, bstats = split_variables(variables)
    rng = jax.random.PRNGKey(1)
    t_rand = np.asarray(jax.random.uniform(rng, (jc.train.n_rays, jc.train.n_samples)))

    optimizer, _ = jax_make_optimizer(jc)
    new_params, new_bs, _, metrics = make_train_step(jr, crit, optimizer, donate=False)(
        params, bstats, optimizer.init(params), jb, rng)

    def loss_fn(p):
        ret, _ = jr.render_train(merge_variables(p, bstats), jb, rng)
        return sum(crit(ret, jb).values()), ret["rgb_map"]

    saved = jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm
    jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm = F64StatsBN, F64StatsIN
    try:
        with jax.enable_x64(True):
            (loss64, rgb64), grads64 = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    finally:
        jax_sparse_net.MaskedBatchNorm, jax_encoder.InstanceNorm = saved

    render = build_render(pc, device="cpu")
    render.load_state_dict(from_jax_variables(variables), strict=True)
    before = {k: v.detach().clone() for k, v in render.state_dict().items()}
    opt, sched, _ = make_optimizer(render, pc)
    pm, ret = train_step(render, Criterion(pc), opt, sched, batch_to_device(b, "cpu"),
                         t_rand=torch.from_numpy(t_rand))
    return {
        "cfg": pc, "render": render, "before": before, "port_metrics": pm, "port_ret": ret,
        "opt": opt, "sched": sched,
        "jax_metrics": jax.tree.map(np.asarray, metrics),
        "jax_after": from_jax_variables(jax.tree.map(np.asarray, merge_variables(new_params, new_bs))),
        "jax_grads": from_jax_variables(jax.tree.map(np.asarray, grads64)),
        "jax_rgb": np.asarray(rgb64), "jax_loss64": float(loss64),
    }


def test_loss_and_rgb_map(step):
    """Loss relative |d| <= 1e-5 against the float32 JAX step (and its
    float64-statistics twin); rgb_map within 3e-5 (values up to 0.2; the
    float32 forward passes differ by ~1e-6 relative, as the gradient test
    says); overflow 0 on both."""
    pl = float(step["port_metrics"]["loss"])
    jl = float(step["jax_metrics"]["loss"])
    assert abs(pl - jl) <= 1e-5 * abs(jl), (pl, jl)
    assert abs(pl - step["jax_loss64"]) <= 1e-5 * abs(jl)
    assert float(step["port_metrics"]["rgb_loss"]) == pl
    np.testing.assert_allclose(step["port_ret"]["rgb_map"].detach().numpy(), step["jax_rgb"],
                               atol=3e-5)
    assert int(step["port_metrics"]["overflow"]) == int(step["jax_metrics"]["overflow"]) == 0


def test_gradients_key_by_key(step):
    """Every parameter's gradient within 1e-3 relative L2 of the JAX
    gradient, but the sparse stack's BatchNorm scales and biases within
    2e-3; the exactly-zero ones (ZERO_GRAD) at rounding-noise level, below
    1e-6 of the whole gradient's norm, on both sides.

    Why 2e-3 there: a BatchNorm bias's gradient is a column sum through the
    train-mode backward, whose terms cancel, and the loss is only piecewise
    smooth (ReLU kinks). In the port alone, scaling one encoder weight
    tensor by 1 + 1e-6 N(0, 1) moves these gradients by up to 4.7e-3 (1e-7
    moves them by 4e-6: a kink is crossed), and the two packages' float32
    forward passes differ by about 1e-6. Measured here: 1.19e-3 at most on
    those tensors, 7.8e-4 at most elsewhere."""
    render, ref = step["render"], step["jax_grads"]
    grads = {k: p.grad for k, p in render.named_parameters()}
    assert set(grads) == set(ref)
    total = float(np.sqrt(sum(float((g.double() ** 2).sum()) for g in ref.values())))
    bn = {k for k, m in render.named_modules() if type(m).__name__ == "MaskedBatchNorm"}
    checked = 0
    for k, g in grads.items():
        r = ref[k].numpy()
        if k in ZERO_GRAD:
            assert np.linalg.norm(r) <= 1e-6 * total and float(g.norm()) <= 1e-6 * total, k
            continue
        err = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
        tol = 2e-3 if k.rsplit(".", 1)[0] in bn else 1e-3
        assert err <= tol, (k, err)
        checked += 1
    assert checked + len(ZERO_GRAD) == len(grads) and len(bn) == 14


def test_batchnorm_running_stats_after_step(step):
    """Every running mean and variance within 1e-6 of the JAX step's new
    batch_stats, moved from their initial values, one update counted."""
    state = step["render"].state_dict()
    keys = [k for k in state if k.endswith(("running_mean", "running_var"))]
    assert len(keys) == 2 * 14  # subm0, then a strided and a double conv per level
    for k in keys:
        np.testing.assert_allclose(state[k].numpy(), step["jax_after"][k].numpy(), atol=1e-6,
                                   err_msg=k)
        assert not torch.equal(state[k], step["before"][k]), k
    assert all(int(state[k]) == 1 for k in state if k.endswith("num_batches_tracked"))


def test_parameters_after_adamw(step):
    """Parameters after the step within 1e-6 of the JAX step's. Adam's first
    step is lr * g / (|g| + 1e-8), about +-lr wherever |g| >> 1e-8: where
    the two steps' directions disagree in sign, or either is not saturated
    (|g| near eps: the exactly-zero gradients' rounding noise), the
    difference may reach 2 lr. The elements that use this allowance are
    counted: under 0.5% of all (measured: 6,367-6,378 of 2,418,052, 0.26%,
    most in the encoder's conv weights; the float32 JAX step's own
    gradients are 0.5-1% off the exact ones, which flips the sign of their
    smallest elements)."""
    lr = step["cfg"].train.lr
    wd = step["cfg"].train.weight_decay
    render, before, after = step["render"], step["before"], step["jax_after"]
    n_all = n_over = 0
    for k, p in render.named_parameters():
        p0, pp, pj = before[k].double(), p.detach().double(), after[k].double()
        # the normalized Adam direction g / (|g| + eps) of each step
        sp = -(pp - p0) / lr - wd * p0
        sj = -(pj - p0) / lr - wd * p0
        special = (torch.sign(sp) != torch.sign(sj)) | (sp.abs() < 0.99) | (sj.abs() < 0.99)
        over = (pp - pj).abs() > 1e-6
        assert bool(special[over].all()), k
        assert float((pp - pj).abs().max()) <= 2 * lr, k
        n_all += p.numel()
        n_over += int(over.sum())
    print(f"elements beyond 1e-6 (within 2 lr): {n_over} of {n_all}")
    assert n_over <= 5e-3 * n_all, (n_over, n_all)


def test_optimizer_and_schedule_state(step):
    """AdamW over every parameter with optax's defaults; after one step
    the schedule is at step 1 (lr(1)), each parameter has Adam state."""
    opt, sched, cfg = step["opt"], step["sched"], step["cfg"]
    group = opt.param_groups[0]
    assert group["betas"] == (0.9, 0.999) and group["eps"] == 1e-8
    assert group["weight_decay"] == cfg.train.weight_decay
    assert len(group["params"]) == len(list(step["render"].parameters()))
    assert sched.last_epoch == 1
    assert all(int(opt.state[p]["step"]) == 1 for p in group["params"])
