"""Batch reductions across the ranks that each hold an equal slice of one
global batch: the global-batch semantics of the FSDP and tensor-parallel
steps (parallel/optree.py:make_gspmd_train_step), which the JAX package
gets from GSPMD partitioning its single-device step.

Inside `global_batch(group, size)`:

  * BatchNorm's training statistics are the global batch's: the per-rank
    E[x] and E[x^2] are all-reduced and divided by the rank count
    (`mean_over_batch`), differentiably (the backward all-reduces the
    statistics' cotangents), so every rank normalises with, and moves
    its running buffers by, the same statistics;
  * a loss term that sums over the batch is multiplied by the rank count
    (`summed_over_batch`): the FSDP reduce-scatter and the explicit
    gradient reductions average the per-rank gradients, and the average
    of size x (local sum) is the gradient of the global sum.

Outside it (one device, and the data-parallel step, whose semantics are
per shard) both functions return their argument as it is. The DTensor
helpers below let single-device code take sharded tensors.

`sequence_sharded` and `expert_sharded` are the contexts under which the
set models run sequence- and expert-parallel (parallel/sp.py,
parallel/ep.py): they stand for the JAX package's model clones with a
mesh axis bound, so the parameters and their names stay the model's own.
"""

from contextlib import contextmanager
from typing import NamedTuple

_group = None
_size = 1


@contextmanager
def global_batch(group, size: int):
    """Reduce the batch statistics and the batch-summed terms over
    `group`, whose `size` ranks each hold an equal slice of the batch.
    A group of one rank (or None) changes nothing."""
    global _group, _size
    prev = _group, _size
    _group, _size = (group, size) if size > 1 else (None, 1)
    try:
        yield
    finally:
        _group, _size = prev


def mean_over_batch(t):
    """The mean over the global batch of a per-rank mean `t` (equal
    slices), differentiable; `t` itself outside `global_batch`."""
    if _group is None:
        return t
    from torch.distributed.nn.functional import all_reduce

    return all_reduce(t, group=_group) / _size


def is_dtensor(t) -> bool:
    """`t` is a torch.distributed DTensor (a tensor-parallel or FSDP
    parameter outside its module's forward, or its gradient)."""
    return type(t).__name__ == "DTensor"


def full_tensor(t):
    """A DTensor gathered whole (differentiable; a collective), any other
    tensor as it is."""
    return t.full_tensor() if is_dtensor(t) else t


def local_tensor(t):
    """A DTensor's local slice (a view), any other tensor as it is."""
    return t.to_local() if is_dtensor(t) else t


def summed_over_batch(t):
    """A per-rank batch sum `t` scaled so that the ranks' averaged
    gradient is the global sum's; `t` itself outside `global_batch`."""
    return t if _group is None else t * _size


# ---------------------------------------------------------------- point and expert shards

class SeqShard(NamedTuple):
    """The point-axis shard a rank holds under sequence parallelism: the
    'seq' group, whether self-attention takes the ring, this rank's index
    on the group and the group's size."""

    group: object
    ring: bool
    index: int
    size: int


_seq: SeqShard | None = None
_expert = None


@contextmanager
def sequence_sharded(group, ring: bool = False):
    """Run the attention set models with the point axis of their clouds and
    activations sharded over `group` (the JAX package's `model.clone(
    seq_axis=..., seq_ring=...)`, parallel/sp.py): every self-attention
    gathers its keys and values from the group (ops/attention.py:
    sequence_sharded_attention, or with `ring` ring_attention), the
    encoder's max-pool spans the group, the decoder decodes this rank's
    slice of its query embeddings and the Chamfer loss is the per-shard
    value (ops/chamfer.py:chamfer_sp). The parameters are the model's own."""
    import torch.distributed as dist

    global _seq
    prev = _seq
    _seq = SeqShard(group, ring, dist.get_rank(group), dist.get_world_size(group))
    try:
        yield
    finally:
        _seq = prev


def seq_shard() -> SeqShard | None:
    """The SeqShard of the enclosing `sequence_sharded`, else None."""
    return _seq


@contextmanager
def expert_sharded(group):
    """Run the mixture-of-experts FFNs expert-parallel over `group` (the
    JAX package's `model.clone(ep_axis=..., moe_local_experts=1)`,
    parallel/ep.py): each rank holds one expert, the local slice of the
    stacked expert parameters, and the tokens reach it through
    all_to_all (parallel/ep.py:moe_ffn_ep)."""
    global _expert
    prev = _expert
    _expert = group
    try:
        yield
    finally:
        _expert = prev


def expert_group():
    """The group of the enclosing `expert_sharded`, else None."""
    return _expert
