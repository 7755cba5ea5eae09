"""Data parallelism over `torch.distributed`, one process per device
(gpnerf_tpu/parallel/dp.py; reference tools/train.py:116-150 with
DistributedDataParallel).

The JAX package shards one process's devices with `shard_map`; here each
rank of a process group is one device, and the semantics are the JAX
package's: parameters and AdamW state replicated (broadcast from the
group's first rank when a step is built, then kept equal by equal updates),
one frame per rank per step, the gradients averaged before the optimizer
step, the masked BatchNorms' running statistics averaged after it (JAX
pmeans them; the reference's DDP leaves each rank its own), the metrics
averaged. The gradient average is one all-reduce of every gradient
flattened into one buffer.

`make_dp_eval_render` splits the eval rays of a frame over the ranks and
`make_dp_demo_render` the progressive renderer's ray pipeline: every rank
runs the frame stage, the pipeline on its slice of the ray set, and the
slices are gathered.

Under gloo, collectives on CUDA tensors go through host copies (several
ranks sharing one card, which NCCL refuses); under NCCL they stay on the
card."""

from __future__ import annotations

import torch
import torch.distributed as dist

from gpnerf_tpu_torch.models.layers import MaskedBatchNorm
from gpnerf_tpu_torch.render.base import src_norm
from gpnerf_tpu_torch.train.step import forward_backward

# the per-ray entries of the progressive renderer's ray dict (`_frame_stage`)
RAY_KEYS = ("rays_o", "rays_d", "near", "far", "ray_ok", "pix_idx", "bins", "zmin")


def _staged(t, group):
    """(the tensor a collective of `group` takes, whether it is a host copy)."""
    if t.is_cuda and dist.get_backend(group) == "gloo":
        return t.cpu(), True
    return t, False


def all_reduce_(t, group=None):
    """In-place sum of `t` over `group`."""
    s, copied = _staged(t, group)
    dist.all_reduce(s, group=group)
    if copied:
        t.copy_(s)
    return t


def broadcast_(t, group=None):
    """In-place broadcast of `t` from the group's first rank."""
    s, copied = _staged(t, group)
    dist.broadcast(s, src=dist.get_global_rank(group or dist.group.WORLD, 0), group=group)
    if copied:
        t.copy_(s)
    return t


def all_gather_rows(t, group=None):
    """Every rank's (n, ...) `t`, concatenated in rank order."""
    s, copied = _staged(t.contiguous(), group)
    parts = [torch.empty_like(s) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, s, group=group)
    out = torch.cat(parts)
    return out.to(t.device) if copied else out


def _flat_apply(tensors, fn):
    """fn on one buffer holding every tensor of `tensors` (one dtype),
    written back into them."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    fn(flat)
    off = 0
    for t in tensors:
        t.copy_(flat[off: off + t.numel()].view_as(t))
        off += t.numel()


def _batchnorm_stats(render):
    """The running means and variances of every MaskedBatchNorm."""
    return [b for m in render.modules() if isinstance(m, MaskedBatchNorm)
            for b in (m.running_mean, m.running_var)]


def _broadcast_state(render, group=None):
    """Make every rank's parameters and floating buffers the group's first
    rank's: one broadcast of one buffer."""
    with torch.no_grad():
        state = [p for p in render.parameters()]
        state += [b for b in render.buffers() if b.is_floating_point()]
        _flat_apply(state, lambda f: broadcast_(f, group))


def make_dp_train_step(render, criterion, optimizer, scheduler, group=None):
    """The data-parallel train step over `group` (the default group when
    None). Returns step(batch, generator=None, t_rand=None) -> (metrics,
    render dict), `train/step.train_step`'s surface: each rank's frame
    forward and backward, one all-reduce mean of all gradients, AdamW and
    the schedule, one all-reduce mean of the BatchNorms' running statistics,
    one of the metrics (`overflow` as the float max of the overflows, as
    JAX's pmean takes it). Parameters and buffers are broadcast from the
    group's first rank when the step is built."""
    n = dist.get_world_size(group)
    _broadcast_state(render, group)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    stats = _batchnorm_stats(render)

    def mean_(flat):
        all_reduce_(flat, group)
        flat /= n

    def step(batch, generator=None, t_rand=None):
        metrics, ret = forward_backward(render, criterion, optimizer, batch, generator, t_rand)
        _flat_apply([p.grad for p in params], mean_)
        optimizer.step()
        scheduler.step()
        with torch.no_grad():
            _flat_apply(stats, mean_)
        keys = list(metrics)
        vec = torch.stack([metrics[k].float() for k in keys])
        mean_(vec)
        return dict(zip(keys, vec.unbind())), ret

    return step


def make_dp_eval_render(render, group=None):
    """The BaseRender eval render with the frame's rays split over the
    group (JAX make_dp_eval_render): every rank builds the volume and
    renders its `eval_ray_cap / n` rays in chunks of `eval_chunk`; the
    slices are gathered. Returns run(batch) -> render_eval's dict over the
    ray cap."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    keys = ("rgb_map", "depth_map", "acc_map", "rgb_in_map")

    @torch.no_grad()
    def run(batch):
        cap = batch["ray_o"].shape[0]
        assert cap % n == 0, (cap, n)
        sl = slice(r * cap // n, (r + 1) * cap // n)
        sub = dict(batch)
        for k in ("ray_o", "ray_d", "near", "far"):
            sub[k] = batch[k][sl]
        out = render.render_eval(sub)
        widths = [out[k].reshape(cap // n, -1).shape[1] for k in keys]
        rows = all_gather_rows(torch.cat([out[k].reshape(cap // n, -1) for k in keys], 1), group)
        cols = rows.split(widths, dim=1)
        return {k: c.reshape(cap, *out[k].shape[1:]) for k, c in zip(keys, cols)}

    return run


def make_dp_demo_render(render, group=None):
    """The progressive render with its ray pipeline split over the group
    (JAX make_dp_demo_render): every rank runs the encoder and the frame
    stage (identical on every rank), then `_ray_pipeline` on its
    `ray_cap / n` slice of the rays, whose point capacities follow the
    slice (`sig_cap` scales with the rays). The colors, pixel indices and
    `ray_ok` of the slices are gathered and scattered into the image.
    Overflows: `ray_overflow` from the local frame stage, the per-ray and
    sigma overflows summed over the ranks (each counts its own slice; a sum
    is never divided by n), 0 for rgb; the counts likewise. Returns
    run(batch) -> render_demo's dict."""
    n = dist.get_world_size(group)
    r = dist.get_rank(group)
    assert render.ray_cap % n == 0, (render.ray_cap, n)
    sl = slice(r * render.ray_cap // n, (r + 1) * render.ray_cap // n)

    @torch.no_grad()
    def run(batch):
        featmaps = render.encoder(src_norm(batch["src_imgs"]))
        pre, tables, rd = render._frame_stage(batch, featmaps)
        local = {k: (v[sl] if k in RAY_KEYS and v is not None else v) for k, v in rd.items()}
        rgb_map, stats = render._ray_pipeline(batch, pre, tables, local)
        keys = ("perray_overflow", "sig_overflow", "n_sigma", "n_rgb")
        counters = all_reduce_(torch.stack([stats[k].long() for k in keys]), group)
        # one gather of (rgb, pixel index, ray_ok) rows; float64 holds each exactly
        rows = all_gather_rows(torch.cat([rgb_map.double(), local["pix_idx"][:, None].double(),
                                          local["ray_ok"][:, None].double()], 1), group)
        full = dict(rd, pix_idx=rows[:, 3].long(), ray_ok=rows[:, 4] > 0)
        return render._assemble(batch, full, rows[:, :3].to(rgb_map.dtype),
                                dict(zip(keys, counters.unbind())))

    return run
