"""What every weight-sharding strategy shares (port of
vae_song_tpu/parallel/optree.py): the optimizer state laid out like the
parameters, the gradient clip over sharded gradients, and the
GSPMD-style train and eval steps that TP, FSDP, TP x DP and TP x FSDP
run.

In JAX, an optax state nests parameter-shaped subtrees (Adam's mu and
nu) among bookkeeping leaves, and each strategy walks it to shard the
moments like their parameters. The port's optimizer holds one moment
pair per parameter slot and a count, so the walk is `shard_opt_state`:
the optimizer rebuilt over the sharded parameters, each moment placed as
its parameter is (a DTensor of the same mesh and placements), the count,
schedule and clip carried over.

The step (`make_gspmd_train_step`) is the single-device step with exact
global-batch semantics, as GSPMD partitions the JAX step: every rank of
the 'data' group takes its slice of the batch; inside
nn.sync.global_batch the BatchNorm statistics are the global batch's and
batch-summed terms are scaled so that the ranks' averaged gradient is
the global one; the gradients are averaged over 'data' (FSDP2's
reduce-scatter for the parameters it manages, one all-reduce for the
others); the clip reduces the true global norm over the sharded
gradients; Adam updates each rank's slice.
"""

import torch
import torch.distributed as dist

from vae_song_tpu_torch.nn import sync
from vae_song_tpu_torch.nn.sync import full_tensor, is_dtensor, local_tensor
from vae_song_tpu_torch.train.state import Adam, TrainState
from vae_song_tpu_torch.train.steps import _TERMS, make_backward_fn


def optimizer_slots(state: TrainState) -> dict:
    """{parameter name: (mu, nu)} of the optimizer's slots, the moments
    gathered whole (a collective where they are sharded)."""
    names = {id(p): name for name, p in state.model.named_parameters()}
    adam = state.optimizer.adam
    return {names[id(p)]: (full_tensor(m).detach(), full_tensor(v).detach())
            for p, m, v in zip(state.optimizer.params, adam.mu, adam.nu)}


@torch.no_grad()
def shard_opt_state(state: TrainState, slots: dict) -> TrainState:
    """`state` with its optimizer rebuilt over the model's parameters as
    they are now (sharded by a strategy) and each slot's moments from
    `slots` ({name: (mu, nu)} of whole tensors, `optimizer_slots` taken
    before the parameters were sharded) laid out like its parameter: a
    DTensor parameter's moments become DTensors of its mesh and
    placements. The count, schedule and clip are kept."""
    from torch.distributed.tensor import distribute_tensor

    old = state.optimizer
    params = [p for _, p in state.model.named_parameters()]
    names = [name for name, _ in state.model.named_parameters()]

    def place(full, p):
        full = full.to(device=local_tensor(p).device, dtype=p.dtype)
        if is_dtensor(p):
            return distribute_tensor(full, p.device_mesh, p.placements)
        return full.clone()

    adam = Adam.__new__(Adam)
    adam.params, adam.b1, adam.b2, adam.eps = params, old.adam.b1, old.adam.b2, old.adam.eps
    adam.mu = [place(slots[n][0], p) for n, p in zip(names, params)]
    adam.nu = [place(slots[n][1], p) for n, p in zip(names, params)]
    old.params, old.adam = params, adam
    return state


def _sharded_mesh_dims(t) -> tuple:
    """The mesh dimensions over which a DTensor is split (Shard
    placements); () for a replicated one or a plain tensor."""
    if not is_dtensor(t):
        return ()
    from torch.distributed.tensor import Shard

    return tuple(i for i, pl in enumerate(t.placements) if isinstance(pl, Shard))


def _reduce_over(value: torch.Tensor, t, dims, op) -> torch.Tensor:
    for i in dims:
        dist.all_reduce(value, op=op, group=t.device_mesh.get_group(i))
    return value


def sharded_global_pnorm(grads, p: float) -> torch.Tensor:
    """The global p-norm (p = inf: the largest absolute element) of
    gradients of which some are split over mesh dimensions (DTensors with
    Shard placements): each group of leaves split over the same
    dimensions sums its local slices, one all-reduce per dimension, and
    the replicated leaves count once, so every rank gets the same norm
    (JAX make_shardmap_clip, :104-174)."""
    groups: dict = {}
    for g in grads:
        key = (_sharded_mesh_dims(g), id(g.device_mesh) if is_dtensor(g) else None)
        local = local_tensor(g).float().reshape(-1)
        part = local.abs().max() if p == float("inf") else (local.abs() ** p).sum()
        if key in groups:
            acc, ref = groups[key]
            groups[key] = (torch.maximum(acc, part) if p == float("inf") else acc + part, ref)
        else:
            groups[key] = (part, g)
    op = dist.ReduceOp.MAX if p == float("inf") else dist.ReduceOp.SUM
    parts = [_reduce_over(acc, ref, key[0], op) for key, (acc, ref) in groups.items()]
    if p == float("inf"):
        return torch.stack(parts).max()
    return sum(parts) ** (1.0 / p)


def make_shardmap_clip(grad_clip: dict | None, norm_fn=None):
    """The in-place gradient clip of `grad_clip` (train/state.py:make_clip)
    over gradients of which some are sharded (JAX make_shardmap_clip): the
    true global norm (`norm_fn(grads, p)`, by default
    `sharded_global_pnorm`, which reads the split from DTensor
    placements), optax's scale
    max_norm / max(norm, max_norm) for p = 2 (no change below max_norm),
    torch's min(1, max_norm / (norm + 1e-6)) for other p, the
    element-wise value clip on each rank's slice. None when clipping is
    off."""
    if not (grad_clip and grad_clip.get("enabled", False)):
        return None
    clip_type = grad_clip.get("clip_type", "norm")
    if clip_type == "value":
        v = float(grad_clip.get("clip_value", 1.0))

        @torch.no_grad()
        def clip_value(grads):
            for g in grads:
                local_tensor(g).clamp_(-v, v)

        return clip_value
    if clip_type != "norm":
        raise ValueError(f"unknown clip_type {clip_type!r}")
    max_norm = float(grad_clip.get("max_norm", 1.0))
    norm_type = float(grad_clip.get("norm_type", 2.0))

    @torch.no_grad()
    def clip(grads):
        if not grads:
            return
        norm = (norm_fn or sharded_global_pnorm)(grads, norm_type)
        if norm_type == 2.0:
            if norm < max_norm:
                return
            for g in grads:
                lg = local_tensor(g)
                lg.copy_((lg / norm.to(lg.dtype)) * max_norm)
            return
        scale = torch.clamp(max_norm / (norm + 1e-6), max=1.0)
        for g in grads:
            local_tensor(g).mul_(scale.to(g.dtype))

    return clip


def _coalesced_mean(tensors, group, n: int) -> None:
    """All-reduce `tensors` (plain, same dtype) as one flat buffer over
    `group`, divided by n, in place."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat.div_(n)
    for t, piece in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(piece.view_as(t))


def make_grad_mean(params, group, n: int):
    """mean() averages the `.grad` of `params` (the parameters FSDP does not
    manage) over `group` of n ranks, a DTensor's local slice for a
    DTensor, one all-reduce a dtype."""

    @torch.no_grad()
    def mean():
        if n == 1:
            return
        by_dtype: dict = {}
        for p in params:
            if p.grad is not None:
                g = local_tensor(p.grad)
                by_dtype.setdefault(g.dtype, []).append(g)
        for ts in by_dtype.values():
            _coalesced_mean(ts, group, n)

    return mean


def data_group(mesh):
    """(the mesh's 'data' process group, its size)."""
    i = mesh.mesh_dim_names.index("data")
    return mesh.get_group("data"), mesh.size(i)


def make_gspmd_train_step(model, optimizer, mesh, fsdp_params=(), grad_mode: str | None = None):
    """The shared train step of TP, FSDP and TP x FSDP (JAX
    jit_gspmd_train_step): step(x, eps, wu_alpha, dropout_rng=None) ->
    the global batch's metrics, x and eps this rank's slice of the global
    batch (mesh.shard_batch). The gradients of `fsdp_params` (the
    parameters fully_shard manages) are reduce-scattered by FSDP2; those
    of every other parameter are averaged over 'data' here. The
    optimizer's clip is replaced by the sharded clip."""
    group, n = data_group(mesh)
    params = [p for p in optimizer.params if p.requires_grad]
    managed = {id(p) for p in fsdp_params}
    mean = make_grad_mean([p for p in params if id(p) not in managed], group, n)
    backward_fn = make_backward_fn(model, model, params, grad_mode, after_backward=mean)
    optimizer.clip = make_shardmap_clip(optimizer.grad_clip)

    def step(x, eps, wu_alpha=0.0, dropout_rng=None):
        with sync.global_batch(group, n):
            m = backward_fn(x, eps, wu_alpha, dropout_rng)
        if n > 1:
            with torch.no_grad():
                dist.all_reduce(m, group=group)
                m = m / n
        optimizer.step()
        return dict(zip(_TERMS, m.unbind()))

    return step


def make_gspmd_eval_step(model, mesh):
    """eval(x, eps, wu_alpha) -> the global batch's {"loss", "recon",
    "reg", "lr"}, x and eps this rank's slice (running BatchNorm
    statistics; batch-summed terms as the train step scales them)."""
    group, n = data_group(mesh)

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.no_grad(), sync.global_batch(group, n):
            outs = model(x, eps)
            m = torch.stack(model.loss(x, *outs, wu_alpha=wu_alpha)).float()
            if n > 1:
                dist.all_reduce(m, group=group)
                m = m / n
        return dict(zip(("loss", "recon", "reg", "lr"), m.unbind()))

    return eval_step
