"""Differentiable collectives of the sequence-, pipeline- and
expert-parallel strategies over a process group, each with the
transpose the JAX package's collective has under shard_map (torch's
all_to_all_single; torch.autograd.Functions of this module for the
others):

  * `all_gather` (lax.all_gather, tiled along a dimension or stacked on
    a new first one): the backward sums every rank's cotangent and keeps
    this rank's slice (psum_scatter);
  * `all_to_all` (lax.all_to_all over the first dimension, equal
    splits): the backward is the same exchange;
  * `rotate` (lax.ppermute one step round the ring; not differentiated:
    the ring attention's Function calls it in its forward and backward);
  * `recv_from` / `send_to`: one activation handed from a pipeline stage
    to the next (lax.ppermute on the 'stage' axis), the backward handing
    its cotangent back;
  * `replicate_from` (pp.py:_replicate_from_psum): one rank's tensor
    broadcast to the group, the backward the identity on that rank and
    nothing on the others;
  * `psum_cotangent` (pp.py:psum_cotangent): the identity, the backward
    summing the cotangent over the group.

Ranks are given as ranks of the group; the point-to-point calls map them
to the global ranks torch.distributed addresses.
"""

import warnings

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_nn


def _global(group, rank: int) -> int:
    return dist.get_global_rank(group, rank) if group is not None else rank


def _reducible(g):
    """A contiguous copy of the cotangent `g` for an in-place all_reduce
    (autograd's gradient buffers are not written in place)."""
    return g.contiguous().clone()


class _AllGather(torch.autograd.Function):
    # torch.distributed.nn.functional.all_gather has this transpose, but on
    # gloo its backward scatters from each group rank as if it were a global
    # one, which fails in a subgroup such as DP x SP's 'seq' rows

    @staticmethod
    def forward(ctx, x, group, dim, stack):
        ctx.group, ctx.dim, ctx.stack = group, dim, stack
        ctx.rank, ctx.n = dist.get_rank(group), dist.get_world_size(group)
        parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
                 for _ in range(ctx.n)]
        dist.all_gather(parts, x.contiguous(), group=group)
        return torch.stack(parts) if stack else torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        g = _reducible(g)
        dist.all_reduce(g, group=ctx.group)
        if ctx.stack:
            return g[ctx.rank], None, None, None
        size = g.shape[ctx.dim] // ctx.n
        return g.narrow(ctx.dim, ctx.rank * size, size), None, None, None


def all_gather(x, group, dim: int = 0, stack: bool = False):
    """Every rank's `x` concatenated along `dim` in rank order (stacked on
    a new first dimension with `stack`), differentiable: the gradient of
    each rank's slice is the sum of the slice's cotangent over the
    ranks."""
    return _AllGather.apply(x, group, dim, stack)


def all_to_all(x, group):
    """Split `x` into as many equal chunks along its first dimension as
    the group has ranks; chunk j goes to rank j, and the chunk from rank
    i lands at position i (lax.all_to_all, split_axis = concat_axis = 0,
    tiled). Its transpose is itself
    (torch.distributed.nn.functional.all_to_all_single)."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with warnings.catch_warnings():
        # deprecated there in favour of a private module; its autograd rule
        # is the one wanted, on gloo and NCCL
        warnings.simplefilter("ignore", FutureWarning)
        return dist_nn.all_to_all_single(out, x.contiguous(), group=group)


def rotate(tensors, group):
    """Each tensor handed one rank on round the group's ring (this rank's
    goes to rank + 1, rank - 1's arrives), all exchanged in one batch of
    non-blocking sends and receives; a group of one rank hands the
    tensors back."""
    n = dist.get_world_size(group)
    if n == 1:
        return list(tensors)
    r = dist.get_rank(group)
    dst, src = _global(group, (r + 1) % n), _global(group, (r - 1) % n)
    outs = [torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors]
    ops = ([dist.P2POp(dist.isend, t.contiguous(), dst, group) for t in tensors]
           + [dist.P2POp(dist.irecv, o, src, group) for o in outs])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return outs


class _Recv(torch.autograd.Function):

    @staticmethod
    def forward(ctx, anchor, shape, dtype, src, group):
        ctx.src, ctx.group = _global(group, src), group
        ctx.anchor = (anchor.shape, anchor.dtype)
        buf = torch.empty(shape, dtype=dtype, device=anchor.device)
        dist.recv(buf, ctx.src, group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        dist.send(g.contiguous(), ctx.src, group=ctx.group)
        shape, dtype = ctx.anchor
        return g.new_zeros(shape, dtype=dtype), None, None, None, None


def recv_from(anchor, shape, dtype, src: int, group):
    """The tensor rank `src` hands this rank with `send_to`; its gradient
    goes back to `src` in the backward. `anchor` (the stage input this
    rank does not read, as the JAX schedule's feed gate does not) ties
    the call into the graph and gets a zero gradient, so what computed it
    runs its backward on every rank (a collective there, such as
    `psum_cotangent`, meets its peers). An anchor outside the graph (an
    input that takes no gradient) is replaced by a leaf that takes one,
    so the backward still hands the cotangent back."""
    if torch.is_grad_enabled() and not anchor.requires_grad:
        anchor = anchor.detach().requires_grad_()
    return _Recv.apply(anchor, tuple(shape), dtype, src, group)


class _Send(torch.autograd.Function):

    @staticmethod
    def forward(ctx, y, dst, group):
        ctx.dst, ctx.group = _global(group, dst), group
        ctx.shape, ctx.dtype = y.shape, y.dtype
        dist.send(y.contiguous(), ctx.dst, group=group)
        return y.new_zeros(())

    @staticmethod
    def backward(ctx, g):
        buf = torch.empty(ctx.shape, dtype=ctx.dtype, device=g.device)
        dist.recv(buf, ctx.dst, group=ctx.group)
        return buf, None, None


def send_to(y, dst: int, group):
    """Hand `y` to rank `dst`; returns a 0-dim token whose backward
    receives y's cotangent from `dst` (pass it on to `replicate_from`,
    which ties it to the loss)."""
    return _Send.apply(y, dst, group)


class _ReplicateFrom(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, src, group, *tokens):
        ctx.owner = dist.get_rank(group) == src
        ctx.n_tokens = len(tokens)
        buf = x.contiguous().clone()
        dist.broadcast(buf, _global(group, src), group=group)
        return buf

    @staticmethod
    def backward(ctx, g):
        # the identity on the owner: every rank computes the downstream
        # loss redundantly, so the owner's cotangent is already the whole
        # one; summing the group's (a broadcast's transpose) would count it
        # once a rank
        zeros = tuple(g.new_zeros(()) for _ in range(ctx.n_tokens))
        return (g if ctx.owner else None, None, None, *zeros)


def replicate_from(x, src: int, group, tokens=()):
    """Rank `src`'s `x` on every rank of the group (the other ranks pass a
    placeholder of its shape and dtype). The gradient flows to the
    owner's `x` as it is and to no other rank's; `tokens` (send_to's)
    each get a zero gradient, which starts their backward."""
    return _ReplicateFrom.apply(x, src, group, *tokens)


class _PsumCotangent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        g = _reducible(g)
        dist.all_reduce(g, group=ctx.group)
        return g, None


def psum_cotangent(x, group):
    """`x` itself; its cotangent summed over the group in the backward."""
    return _PsumCotangent.apply(x, group)
