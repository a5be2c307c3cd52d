"""Pipeline parallelism: GPipe over a 'stage' process group (port of
vae_song_tpu/parallel/pp.py).

The layer axis of a stack of identical blocks is split into S contiguous
stages, one a rank of the 'stage' group; the batch is split into M
microbatches. Stage s runs each microbatch through its layers as it
arrives from stage s - 1 and hands the result to stage s + 1, by
point-to-point sends inside autograd Functions (nn/collectives.py), so
the JAX schedule's M + S - 1 ticks happen as the ranks wait on each
other: stage s works on microbatch m while stage s + 1 works on m - 1.
The last stage's outputs are broadcast to every stage
(`nn.collectives.replicate_from`), whose backward is the identity on the
last stage and nothing elsewhere: the loss after the pipeline is
computed on every stage alike, so the last stage's cotangent is already
the whole one (JAX `_replicate_from_psum`, :43-65; a backward that
summed the stages' cotangents would scale every pipeline gradient by S,
which Adam's scale invariance hides and a clip or SGD does not).
`.backward()` through that graph is the pipelined backprop: the
cotangents travel back stage by stage and each stage computes its own
layers' gradients. `nn.collectives.psum_cotangent` (JAX :69-96) is the
identity whose backward sums over the stages, for a replicated value
that feeds the pipeline's first stage a second time (SetLRVAE's
re-encode, parallel/pp_setvae.py).

The schedule is hand-written rather than torch.distributed.pipelining's:
the set models run the decoder and the loss redundantly on every stage
and SetLRVAE takes two pipeline passes a step, which the library's
schedules do not express.

Every stage receives the microbatches (only the first reads them: the
others pass them as the receive's anchor, which gets a zero gradient,
as the JAX feed gate gives them), so a computation that produced them
runs its backward on every stage.
"""

from typing import Callable

import torch
import torch.distributed as dist

from vae_song_tpu_torch.nn import collectives

STAGE_AXIS = "stage"


def make_pp_mesh(n_stages: int):
    """The ('stage',) DeviceMesh over n_stages ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from vae_song_tpu_torch.parallel.mesh import device_type

    return init_device_mesh(device_type(), (n_stages,), mesh_dim_names=(STAGE_AXIS,))


def _pipeline(stage_fn: Callable, micro, group, act_dtype=None):
    """The GPipe schedule over the 'stage' group `group` (JAX :102).

    stage_fn(x) -> y applies THIS stage's layers (one shape across the
    stages). `micro`: the M microbatch inputs, the same on every stage.
    `act_dtype` is the dtype of a stage's output (default: the inputs'):
    the activations travel, enter the next stage and leave the pipeline
    in it, as they pass from layer to layer on one device, so a
    one-stage pipeline computes what the layers compute unsplit. (The JAX
    schedule's `jnp.where` promotes them to the inputs' dtype, f32 under
    mixed precision: its stages after the first add their first residual
    in f32, and its pool takes an f32 buffer.) Returns the last stage's
    outputs, concatenated along the batch, on every stage."""
    s, n = dist.get_rank(group), dist.get_world_size(group)
    act = act_dtype or micro[0].dtype
    outs, tokens = [], []
    for xm in micro:
        inp = xm if s == 0 else collectives.recv_from(xm, xm.shape, act, s - 1, group)
        y = stage_fn(inp)
        if s < n - 1:
            tokens.append(collectives.send_to(y.to(act), s + 1, group))
        else:
            outs.append(y.to(act))
    if s == n - 1:
        out = torch.cat(outs)
    else:
        out = micro[0].new_zeros((sum(m.shape[0] for m in micro), *micro[0].shape[1:]),
                                 dtype=act)
    return collectives.replicate_from(out, n - 1, group, tokens)


def _layer(stacked: dict, i: int) -> dict:
    return {k: v[i] for k, v in stacked.items()}


def stack_block_params(init_fn: Callable, generator, n_layers: int) -> dict:
    """Per-layer parameter dicts init_fn(generator) stacked on a leading
    layer axis: the layout of `scan_blocks` and of the stage split."""
    per_layer = [init_fn(generator) for _ in range(n_layers)]
    return {k: torch.stack([p[k] for p in per_layer]) for k in per_layer[0]}


def scan_blocks(block_apply: Callable, stacked: dict, x):
    """The single-device reference: every stacked layer in order."""
    for i in range(next(iter(stacked.values())).shape[0]):
        x = block_apply(_layer(stacked, i), x)
    return x


def _check_layers(n_layers: int, n_stages: int) -> None:
    if n_layers % n_stages != 0:
        raise ValueError(f"{n_layers} layers do not divide over {n_stages} stages")


def shard_pp_state(stacked: dict, mesh) -> dict:
    """This stage's contiguous slice of the stacked layers, as leaf tensors
    that take gradients (JAX :207; the caller builds its optimizer over
    them, so the moments are the slice's too)."""
    group = mesh.get_group(STAGE_AXIS)
    s, n = dist.get_rank(group), dist.get_world_size(group)
    n_layers = next(iter(stacked.values())).shape[0]
    _check_layers(n_layers, n)
    per = n_layers // n
    return {k: v[s * per:(s + 1) * per].detach().clone().requires_grad_()
            for k, v in stacked.items()}


def _stage_fn(block_apply, local: dict):
    def run(x):
        return scan_blocks(block_apply, local, x)

    return run


def make_pp_apply(block_apply: Callable, mesh, n_layers: int, n_micro: int):
    """pp_fn(local, x) -> y: the pipelined forward over `mesh`'s 'stage'
    group (JAX :157); `local` is this stage's slice (`shard_pp_state`), x
    the whole batch [B, ...] with B % n_micro == 0, y on every stage."""
    group = mesh.get_group(STAGE_AXIS)
    _check_layers(n_layers, dist.get_world_size(group))

    def pp_fn(local: dict, x):
        if x.shape[0] % n_micro:
            raise ValueError(f"a batch of {x.shape[0]} does not divide into {n_micro} "
                             "microbatches")
        return _pipeline(_stage_fn(block_apply, local), x.split(x.shape[0] // n_micro), group)

    return pp_fn


def make_pp_train_step(block_apply: Callable, loss_fn: Callable, optimizer, mesh,
                       n_layers: int, n_micro: int):
    """Pipelined training (JAX :215): step(local, x, target) -> loss, the
    gradient of loss_fn(y, target) through the schedule; each stage's
    gradients stay on it and `optimizer` (over this stage's slice) takes
    one update."""
    pp_fn = make_pp_apply(block_apply, mesh, n_layers, n_micro)

    def step(local: dict, x, target):
        optimizer.zero_grad()
        loss = loss_fn(pp_fn(local, x), target)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step
