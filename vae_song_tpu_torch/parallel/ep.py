"""The Switch-style top-1 mixture-of-experts feed-forward and expert
parallelism (port of vae_song_tpu/parallel/ep.py): on one device
(MoEParams, init_moe, _capacity, _dispatch_combine, _expert_ffn,
moe_ffn_dense, :56-130) and with one expert a rank over an 'expert'
process group, the tokens exchanged by all_to_all (moe_ffn_ep and the
sharded steps, :132-405).

Routing, as in JAX: router logits [T, E] = x @ router in x's dtype, the
softmax of those logits in that dtype (jax.nn.softmax's formula), the
top-1 expert by argmax (the first index on ties, as jnp.argmax), its
probability the gate; each expert takes at most C = ceil(T / E *
capacity_factor) tokens in arrival order, and the tokens past that are
dropped (their output is zero).

JAX builds the one-hot dispatch and combine tensors [T, E, C] and
contracts them with einsums. Each of those sums has one non-zero term, so
the port computes the same numbers by index and never materialises
[T, E, C] (43 GB in bf16 at the shipped config with 4 experts): the
tokens of each expert's queue are scattered into [E, C, D] (zeros in the
empty slots), the two expert products run as batched matmuls (JAX
computes them with plain einsums too), and each kept token takes
bf16(gate * its slot's output) back. The queue positions are counted
exactly in int64: JAX takes the cumulative sum of the one-hot in x's
dtype, which in bf16 stops counting exactly past 256 tokens an expert, so
there several tokens share a slot (ROADMAP.md Queue 3). The gate carries
the router's gradient; the argmax and the dropped tokens carry none.

Expert parallelism (`moe_ffn_ep`): each rank routes its own tokens with
the replicated router, the capacity counted from its LOCAL tokens
(JAX :143), scatters them into [E, C, D], and `all_to_all` hands row e to
rank e, which runs its one expert on the [E (source rank), C, D] rows it
receives; the inverse all_to_all brings the outputs home. The expert
parameters are DTensors split on their expert dimension over the
'expert' mesh (`shard_setvae_ep_state`; their names and the state_dict
stay the model's, a checkpoint gathers them whole). The gradient
convention is JAX's (:325-346): each rank's loss is its shard's mean, an
expert's gradient arrives complete on its rank through the all_to_all's
transpose and is divided by the rank count, every other gradient is
averaged over the ranks; the clip reduces the true global norm. So the
EP step equals data parallelism with the dense MoE on each shard (JAX
tests/test_moe_setvae.py:85).
"""

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from vae_song_tpu_torch.nn import collectives
from vae_song_tpu_torch.nn.initializers import uniform_

EXPERT_AXIS = "expert"


class MoEParams(NamedTuple):
    """router [D, E]; the experts stacked [E, ...] (JAX's layout: the
    products are x @ w, not Linear-shaped)."""

    router: torch.Tensor    # [D, E]
    w1: torch.Tensor        # [E, D, H]
    b1: torch.Tensor        # [E, H]
    w2: torch.Tensor        # [E, H, D]
    b2: torch.Tensor        # [E, D]


def init_moe(d_model: int, hidden: int, n_experts: int, generator=None) -> MoEParams:
    """U(-1/sqrt(D), 1/sqrt(D)) router and first products, U(-1/sqrt(H),
    1/sqrt(H)) second products, zero biases (JAX `init_moe`), drawn from
    `generator` in the order router, w1, w2."""
    s1, s2 = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(hidden)
    router = uniform_(torch.empty(d_model, n_experts), s1, generator)
    w1 = uniform_(torch.empty(n_experts, d_model, hidden), s1, generator)
    w2 = uniform_(torch.empty(n_experts, hidden, d_model), s2, generator)
    return MoEParams(router, w1, torch.zeros(n_experts, hidden), w2,
                     torch.zeros(n_experts, d_model))


def _capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return int(np.ceil(n_tokens / n_experts * capacity_factor))


def _softmax(logits):
    """jax.nn.softmax over the last axis, op for op in the logits' dtype:
    exp(x - max), then that over its sum."""
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _dispatch_combine(x, router, n_experts: int, capacity: int):
    """Top-1 routing of tokens x [T, D]: (gate [T] in x's dtype, slot [T]
    int64: expert * capacity + the token's position in its expert's queue,
    keep [T] bool: the position is under the capacity)."""
    probs = _softmax(x @ router)                         # [T, E]
    expert = probs.argmax(dim=-1)                        # [T]
    gate = probs.gather(1, expert[:, None])[:, 0]        # [T]
    # each expert's running count over the tokens, scanned along the
    # contiguous axis of [E, T]: a scan down [T, E]'s 4 columns takes
    # CUDA's outer-dimension kernel, 22.0 ms a call at T = 131072 on an
    # H100 at 700 W, two thirds of the MoE SetVAE step
    # (scripts/ab_moe_step.py)
    counts = torch.nn.functional.one_hot(expert, n_experts).t().contiguous().cumsum(dim=1)
    pos = counts.gather(0, expert[None])[0] - 1
    return gate, expert * capacity + pos, pos < capacity


def _expert_ffn(w1, b1, w2, b2, h):
    """relu(h @ w1 + b1) @ w2 + b2 over the stacked experts, h [E, C, D]."""
    return torch.bmm(torch.relu(torch.bmm(h, w1) + b1[:, None, :]), w2) + b2[:, None, :]


def _moe(params: MoEParams, x, capacity_factor: float, experts):
    """Route x [T, D] over the router's E experts with the capacity of
    T tokens, scatter the kept tokens into [E, C, D], run
    `experts(expert_in)` -> [E, C, D], and gather each kept token's
    output back, scaled by its gate."""
    t, d = x.shape
    e = params.router.shape[1]
    c = _capacity(t, e, capacity_factor)
    gate, slot, keep = _dispatch_combine(x, params.router, e, c)
    # the dropped tokens go to one row past the slots, which is cut off:
    # a scatter whose gradient is a gather, so no sum lands on a shared row
    slot = torch.where(keep, slot, e * c)
    expert_in = x.new_zeros(e * c + 1, d).index_copy(0, slot, x)[:-1].view(e, c, d)
    out = experts(expert_in)
    # the dropped tokens take that zero row back
    out = torch.cat([out.reshape(e * c, d), out.new_zeros(1, d)])
    return gate[:, None] * out.index_select(0, slot)


def moe_ffn_dense(params: MoEParams, x, capacity_factor: float = 1.25):
    """Every expert on this device: x [T, D] -> [T, D] (JAX
    `moe_ffn_dense`), by index (the module's docstring)."""
    return _moe(params, x, capacity_factor,
                lambda h: _expert_ffn(params.w1, params.b1, params.w2, params.b2, h))


def moe_ffn_ep(local_params: MoEParams, x_local, group, capacity_factor: float = 1.25):
    """Expert-parallel evaluation over `group`, one expert a rank (JAX
    :132): `local_params` holds the replicated router [D, E] and this
    rank's expert slices [1, ...]; x_local is this rank's tokens
    [T_local, D] -> [T_local, D]. The capacity is the local one."""
    e = local_params.router.shape[1]
    if dist.get_world_size(group) != e:
        raise ValueError(f"{e} experts over {dist.get_world_size(group)} ranks: "
                         "expert parallelism holds one expert a rank")

    def experts(expert_in):
        c, d = expert_in.shape[1:]
        # [E (source rank), C, D]: every row now belongs to this rank's expert
        recv = collectives.all_to_all(expert_in, group)
        out = _expert_ffn(local_params.w1, local_params.b1, local_params.w2, local_params.b2,
                          recv.reshape(1, e * c, d))
        return collectives.all_to_all(out.view(e, c, d), group)

    return _moe(local_params, x_local, capacity_factor, experts)


# ---------------------------------------------------------------- the sharded state


def _is_expert_leaf(name: str) -> bool:
    """A MoE FFN's expert stack (w1, b1, w2, b2 exist only there: Dense
    layers hold weight/bias, LayerNorm weight/bias, the router is
    `router`)."""
    return _leaf_name(name) in ("w1", "b1", "w2", "b2")


def _leaf_name(name: str) -> str:
    return name.rsplit(".", 1)[-1]


def setvae_ep_specs(model) -> dict:
    """{parameter name: ("expert",) for the expert stacks (split on their
    first dimension), () for every other (replicated)} (JAX :283)."""
    return {n: (EXPERT_AXIS,) if _is_expert_leaf(n) else ()
            for n, _ in model.named_parameters()}


def make_ep_mesh(n_experts: int):
    """The ('expert',) DeviceMesh over n_experts ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from vae_song_tpu_torch.parallel.mesh import device_type

    return init_device_mesh(device_type(), (n_experts,), mesh_dim_names=(EXPERT_AXIS,))


def _distribute_experts(module, names, mesh):
    """Each of `names` on `module` replaced by a Parameter holding a DTensor
    split on dimension 0 over `mesh`."""
    from torch.distributed.tensor import Shard, distribute_tensor

    for name in names:
        p = getattr(module, name)
        setattr(module, name, torch.nn.Parameter(distribute_tensor(p.data, mesh, [Shard(0)]),
                                                 requires_grad=p.requires_grad))


def shard_moe(params: MoEParams, mesh) -> MoEParams:
    """The router replicated, the expert stacks split on the 'expert'
    mesh (DTensors; JAX :172)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    return MoEParams(params.router, *(distribute_tensor(t, mesh, [Shard(0)])
                                      for t in params[1:]))


def _local(params: MoEParams) -> MoEParams:
    from vae_song_tpu_torch.nn.sync import local_tensor

    return MoEParams(*(local_tensor(t) for t in params))


def make_ep_apply(mesh, capacity_factor: float = 1.25):
    """fn(params, x_local) -> y_local: the expert-parallel forward over
    `mesh`'s 'expert' group, params from `shard_moe` (JAX :186)."""
    group = mesh.get_group(EXPERT_AXIS)

    def apply(params: MoEParams, x_local):
        return moe_ffn_ep(_local(params), x_local, group, capacity_factor)

    return apply


def _opt_specs() -> MoEParams:
    """The placement of each parameter of `shard_moe` and of its Adam
    moments (JAX :205): the router whole, the expert stacks split on the
    'expert' mesh."""
    return MoEParams((), *((EXPERT_AXIS,),) * 4)


def shard_moe_opt(optimizer, params: MoEParams, mesh) -> None:
    """The optimizer over `params` (shard_moe's), each Adam moment laid
    out as `_opt_specs` says (JAX :213)."""
    from torch.distributed.tensor import Shard, distribute_tensor

    adam = optimizer.adam
    optimizer.params = adam.params = list(params)
    for i, spec in enumerate(_opt_specs()):
        if spec:
            adam.mu[i] = distribute_tensor(adam.mu[i], mesh, [Shard(0)])
            adam.nu[i] = distribute_tensor(adam.nu[i], mesh, [Shard(0)])


def make_ep_train_step(optimizer, mesh, params: MoEParams, capacity_factor: float = 1.25):
    """The expert-parallel regression step (MSE; JAX :226): step(x_local,
    target_local) -> the loss, x this rank's tokens. The loss is the local
    sum over the global element count, so an expert's gradient is complete
    on its rank without a collective; the router's is summed over the
    ranks (psum)."""
    group = mesh.get_group(EXPERT_AXIS)
    n = dist.get_world_size(group)

    def step(x, target):
        optimizer.zero_grad()
        y = moe_ffn_ep(_local(params), x, group, capacity_factor)
        loss = ((y - target) ** 2).sum() / (x.shape[0] * n * y.shape[-1])
        loss.backward()
        with torch.no_grad():
            dist.all_reduce(params.router.grad, group=group)
            loss = loss.detach().clone()
            dist.all_reduce(loss, group=group)
        optimizer.step()
        return loss

    return step


def shard_setvae_ep_state(state, mesh):
    """The first rank's state on every rank (mesh.replicate_state), then
    every MoE FFN's expert stacks split over the 'expert' mesh, one
    expert a rank, Adam's moments with them (JAX :292)."""
    from vae_song_tpu_torch.nn.moe import MoEFFN
    from vae_song_tpu_torch.parallel import optree
    from vae_song_tpu_torch.parallel.mesh import replicate_state

    replicate_state(state, mesh)
    slots = optree.optimizer_slots(state)
    for m in state.model.modules():
        if isinstance(m, MoEFFN):
            _distribute_experts(m, ("w1", "b1", "w2", "b2"), mesh)
    return optree.shard_opt_state(state, slots)


def _check_ep_model(model, n_exp: int):
    from vae_song_tpu_torch.models.setvae import SetEncoderAttn

    if getattr(model, "moe_experts", 0) != n_exp:
        raise ValueError(
            f"model.moe_experts={getattr(model, 'moe_experts', 0)} must equal "
            f"the 'expert' mesh axis size ({n_exp}): one expert per device"
        )
    if not isinstance(getattr(model, "encoder", None), SetEncoderAttn):
        raise NotImplementedError("expert parallelism needs the attention set models")


def make_setvae_ep_train_step(model, optimizer, mesh, grad_clip: dict | None = None):
    """Expert-parallel train step of an attention SetVAE / SetLRVAE with
    moe_experts == the 'expert' mesh's size (JAX :306):
    step(x, eps, wu_alpha, dropout_rng=None) -> the metrics averaged over
    the ranks, x and eps this rank's batch shard, the state from
    `shard_setvae_ep_state`. The expert gradients are divided by the rank
    count and the others averaged (JAX :343-346), then the clip of
    `grad_clip` (default: the optimizer's) with the true global norm
    (optree.make_shardmap_clip: the expert slices' norms summed over the
    ranks), then one Adam update."""
    from vae_song_tpu_torch.nn.sync import expert_sharded, local_tensor
    from vae_song_tpu_torch.parallel import optree
    from vae_song_tpu_torch.train.steps import _TERMS, make_backward_fn

    group = mesh.get_group(EXPERT_AXIS)
    n_exp = dist.get_world_size(group)
    _check_ep_model(model, n_exp)
    params = [p for p in optimizer.params if p.requires_grad]
    names = {id(p): n for n, p in model.named_parameters()}
    experts = [p for p in params if _is_expert_leaf(names[id(p)])]
    mean = optree.make_grad_mean([p for p in params if not _is_expert_leaf(names[id(p)])],
                                 group, n_exp)

    @torch.no_grad()
    def reduce():
        for p in experts:
            if p.grad is not None:
                local_tensor(p.grad).div_(n_exp)
        mean()

    backward_fn = make_backward_fn(model, model, params, after_backward=reduce)
    optimizer.clip = optree.make_shardmap_clip(
        optimizer.grad_clip if grad_clip is None else grad_clip)

    def step(x, eps, wu_alpha=0.0, dropout_rng=None):
        with expert_sharded(group):
            m = backward_fn(x, eps, wu_alpha, dropout_rng)
        with torch.no_grad():
            for b in model.buffers():
                if b.is_floating_point():
                    optree._coalesced_mean([b], group, n_exp)
            optree._coalesced_mean([m], group, n_exp)
        optimizer.step()
        return dict(zip(_TERMS, m.unbind()))

    return step


def make_setvae_ep_eval_step(model, mesh):
    """Expert-parallel eval step (JAX :384): eval(x, eps, wu_alpha) -> the
    metrics of this rank's batch shard averaged over the ranks."""
    from vae_song_tpu_torch.nn.sync import expert_sharded
    from vae_song_tpu_torch.parallel import optree

    group = mesh.get_group(EXPERT_AXIS)
    n_exp = dist.get_world_size(group)
    _check_ep_model(model, n_exp)

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.no_grad(), expert_sharded(group):
            outs = model(x, eps)
            m = torch.stack(model.loss(x, *outs, wu_alpha=wu_alpha)).float()
            optree._coalesced_mean([m], group, n_exp)
        return dict(zip(("loss", "recon", "reg", "lr"), m.unbind()))

    return eval_step
