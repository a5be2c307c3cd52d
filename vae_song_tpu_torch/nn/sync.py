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
"""

from contextlib import contextmanager

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
