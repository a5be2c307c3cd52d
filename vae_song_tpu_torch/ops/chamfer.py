"""Symmetric Chamfer distance for point clouds (port of
vae_song_tpu/ops/chamfer.py).

Reference semantics: squared-L2 nearest-neighbour distances both ways,
mean over points each way, sum the two means, mean over batch.

  * `chamfer_distance` -- plain tiled PyTorch: the [B, N, N] distance
    matrix never exists beyond one [B, T, N] tile. The off-kernel path.

  * `chamfer_nn_packed` -- the port of the TPU kernel `_chamfer_kernel`
    to a hand-written Hopper kernel (csrc/chamfer_fwd.cu): one launch
    computes each squared distance once and derives both packed keys from
    it, `(bits(d2) & ~0x7FF) | j` for the pred side and `... | i` for the
    gt side, so one int32 min a side gives the min distance (truncated by
    <= 2^-12 relative) and the exact argmin (lower index at ties). The
    gt side combines across pred tiles by an int32 atomicMin a column
    and tile, exact and independent of order, into a key row the wrapper
    fills; the cloud's last tile unpacks it. `chamfer_nn_packed_plain`
    is the same packed computation in PyTorch.

  * `chamfer_bwd` -- the port of the TPU kernel `_chamfer_bwd_kernel`
    (csrc/chamfer_bwd.cu): the gradient routed through the saved
    argmins. A block per cloud and side inverts the other side's argmins
    into per-point lists with a stable counting sort, so the work is
    O(N) and each point subtracts its sources' terms in ascending index
    order; no floating-point atomics. `chamfer_bwd_plain` ports
    `_chamfer_bwd_xla` (gather, then `index_add`).

  * `chamfer_distance_packed` -- a torch.autograd.Function: forward from
    the packed keys (the kernel's value), backward through
    `chamfer_bwd`, scaled by the incoming gradient and cast to the
    clouds' dtype (`_chamfer_bwd`).

`chamfer_sp` is the sequence-parallel value of one shard of the points
(the plain minima; no kernel, as in JAX).

`best_chamfer` takes `chamfer_distance_packed` for CUDA clouds that pass
`packed_chamfer_ok` -- the JAX package's shape gate, not a fallback: a
batch in blocks of 8, both clouds in multiples of 128 points, at most
MAX_PACKED_N (larger clouds do not fit the packed key's 11 index bits)
-- and the exact tiled path everywhere else.
"""

import torch

from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.nn.collectives import all_gather

_DENSE_LIMIT = 1024  # below this many points, build the full matrix
MAX_PACKED_N = 2048  # 11 index bits
_BB = 8              # the JAX kernel's batch block (chamfer.py:83)
_IDX_BITS = 0x7FF
_VAL_MASK = ~0x7FF
_PLAIN_TILE = 256    # query points per chunk of the plain packed version


def _sq_dists(a, b):
    """Squared pairwise distances [B, Na, Nb] by the inner-product
    expansion, clamped at 0 (chamfer.py:_sq_dists)."""
    a2 = (a * a).sum(-1)[..., :, None]
    b2 = (b * b).sum(-1)[..., None, :]
    ab = torch.einsum("bnd,bmd->bnm", a, b)
    return torch.clamp(a2 + b2 - 2.0 * ab, min=0.0)


def _min_dists_tiled(query, ref, tile: int):
    """For each query point, min squared distance to ref. [B, Nq]."""
    return torch.cat(
        [_sq_dists(query[:, s:s + tile], ref).amin(dim=-1)
         for s in range(0, query.shape[1], tile)],
        dim=1,
    )


def chamfer_distance(points_pred, points_gt, tile: int = 512):
    """Symmetric squared Chamfer distance, scalar (plain, tiled)."""
    pred, gt = points_pred.float(), points_gt.float()
    if max(pred.shape[1], gt.shape[1]) <= _DENSE_LIMIT:
        d2 = _sq_dists(pred, gt)
        min_p2g = d2.amin(dim=2)
        min_g2p = d2.amin(dim=1)
    else:
        min_p2g = _min_dists_tiled(pred, gt, tile)
        min_g2p = _min_dists_tiled(gt, pred, tile)
    return (min_p2g.mean(dim=1) + min_g2p.mean(dim=1)).mean()


def chamfer_sp(pred_local, gt_local, group, tile: int = 512):
    """Sequence-parallel Chamfer (JAX chamfer.py:370): the point axes of
    both clouds sharded over `group`. Each rank gathers the opposite
    cloud and takes the minima of its own points only, by the plain
    path (`_sq_dists`, or tiled past _DENSE_LIMIT points); returns the
    PER-SHARD value

        mean_{local pred} min_gt d^2 + mean_{local gt} min_pred d^2,

    batch-averaged, whose mean over the shards is the full Chamfer. The
    gathers' backward brings every rank's gradient for a point home."""
    pred, gt = pred_local.float(), gt_local.float()
    pred_full = all_gather(pred, group, dim=1)
    gt_full = all_gather(gt, group, dim=1)

    def local_min(query, ref):
        if max(query.shape[1], ref.shape[1]) <= _DENSE_LIMIT:
            return _sq_dists(query, ref).amin(dim=2)
        return _min_dists_tiled(query, ref, tile)

    return (local_min(pred, gt_full).mean(dim=1) + local_min(gt, pred_full).mean(dim=1)).mean()


def _packed_keys_plain(query, ref):
    """[B, Nq] int32 packed keys of query against ref, in PyTorch."""
    idx = torch.arange(ref.shape[1], dtype=torch.int32, device=ref.device)
    keys = []
    for s in range(0, query.shape[1], _PLAIN_TILE):
        diff = query[:, s:s + _PLAIN_TILE, None, :] - ref[:, None, :, :]
        dx, dy, dz = diff.unbind(-1)
        # ((dx*dx) + (dy*dy)) + (dz*dz): the kernel's order, no FMA
        d2 = (dx * dx + dy * dy) + dz * dz
        k = (d2.view(torch.int32) & _VAL_MASK) | idx
        keys.append(k.amin(dim=2))
    return torch.cat(keys, dim=1)


def _unpack(keys):
    return (keys & _VAL_MASK).view(torch.float32), keys & _IDX_BITS


def _check(pred, gt):
    if pred.dim() != 3 or gt.dim() != 3 or pred.shape[2] != 3 or gt.shape[2] != 3:
        raise ValueError(f"clouds must be [B, N, 3], got {tuple(pred.shape)}, {tuple(gt.shape)}")
    if pred.shape[0] != gt.shape[0]:
        raise ValueError(f"batch sizes differ: {pred.shape[0]} vs {gt.shape[0]}")
    if pred.dtype != torch.float32 or gt.dtype != torch.float32:
        raise TypeError(f"clouds must be float32, got {pred.dtype}, {gt.dtype}")
    if pred.device != gt.device:
        raise ValueError("clouds must lie on one device")
    if max(pred.shape[1], gt.shape[1]) > MAX_PACKED_N:
        raise ValueError(
            f"packed keys hold indices below {MAX_PACKED_N + 1}; got clouds of "
            f"{pred.shape[1]} and {gt.shape[1]} points"
        )
    if min(pred.shape[1], gt.shape[1]) == 0:
        raise ValueError("clouds must hold at least one point")


def chamfer_nn_packed_plain(pred, gt):
    """Plain PyTorch version of the kernel: (minp, argp, ming, argg)."""
    _check(pred, gt)
    minp, argp = _unpack(_packed_keys_plain(pred, gt))
    ming, argg = _unpack(_packed_keys_plain(gt, pred))
    return minp, argp, ming, argg


def chamfer_nn_packed(pred, gt):
    """Nearest-neighbour minima and argminima both ways, from packed keys.

    pred [B, Np, 3], gt [B, Ng, 3] float32, Np, Ng <= 2048. Returns
    (minp [B, Np] f32, argp [B, Np] int32, ming [B, Ng] f32, argg [B, Ng]
    int32), the outputs of the JAX `_chamfer_pallas_fwd_impl`. CUDA
    tensors launch the Hopper kernel once for both sides; CPU tensors take
    the plain version. `chamfer_nn_packed.launches` counts kernel
    launches."""
    _check(pred, gt)
    if pred.device.type == "cpu":
        return chamfer_nn_packed_plain(pred, gt)
    _kernels.check_device(pred)
    if not (pred.is_contiguous() and gt.is_contiguous()):
        raise ValueError("the Chamfer kernel reads contiguous [B, N, 3] clouds")
    b, np_, _ = pred.shape
    ng = gt.shape[1]
    minp = torch.empty((b, np_), dtype=torch.float32, device=pred.device)
    ming = torch.empty((b, ng), dtype=torch.float32, device=pred.device)
    argp = torch.empty((b, np_), dtype=torch.int32, device=pred.device)
    argg = torch.empty((b, ng), dtype=torch.int32, device=pred.device)
    # the gt-side key row the CTAs combine into, then a count a cloud
    scratch = torch.full((b * (ng + 1),), 0x7FFFFFFF, dtype=torch.int32, device=pred.device)
    _kernels.launch(
        "vst_chamfer_nn_packed", pred.device, pred.data_ptr(), gt.data_ptr(),
        minp.data_ptr(), argp.data_ptr(), ming.data_ptr(), argg.data_ptr(),
        scratch.data_ptr(), b, np_, ng,
    )
    chamfer_nn_packed.launches += 1
    return minp, argp, ming, argg


chamfer_nn_packed.launches = 0


def _scatter_add(base, idx, updates):
    """base [B, N, 3] plus updates [B, M, 3] added at rows idx [B, M]
    (`base.at[bidx, idx].add(updates)`)."""
    b, n, _ = base.shape
    flat = (idx + torch.arange(b, device=idx.device)[:, None] * n).reshape(-1)
    return base.reshape(b * n, 3).index_add(0, flat, updates.reshape(-1, 3)).view(b, n, 3)


def chamfer_bwd_plain(pred, gt, argp, argg):
    """Plain PyTorch version of the backward kernel, the port of
    `_chamfer_bwd_xla`: (d_pred, d_gt) of the Chamfer value for an
    incoming gradient of 1, f32."""
    b, np_, _ = pred.shape
    ng = gt.shape[1]
    argp, argg = argp.long(), argg.long()
    nn_g = torch.gather(gt, 1, argp[..., None].expand(-1, -1, 3))      # gt_{argp_i}
    d_pred_1 = 2.0 * (pred - nn_g) / (b * np_)
    nn_p = torch.gather(pred, 1, argg[..., None].expand(-1, -1, 3))    # pred_{argg_j}
    diff_g = 2.0 * (gt - nn_p) / (b * ng)
    return _scatter_add(d_pred_1, argg, -diff_g), _scatter_add(diff_g, argp, -d_pred_1)


def _check_bwd(pred, gt, argp, argg):
    _check(pred, gt)
    b, np_, _ = pred.shape
    ng = gt.shape[1]
    if argp.shape != (b, np_) or argg.shape != (b, ng):
        raise ValueError(f"argp / argg must be [B, Np] / [B, Ng], got "
                         f"{tuple(argp.shape)}, {tuple(argg.shape)}")
    if argp.dtype != torch.int32 or argg.dtype != torch.int32:
        raise TypeError(f"argp / argg must be int32, got {argp.dtype}, {argg.dtype}")


def chamfer_bwd(pred, gt, argp, argg):
    """(d_pred, d_gt) f32 of the Chamfer value through the forward's
    argmins (argp: pred -> gt, argg: gt -> pred, int32), for an incoming
    gradient of 1. CUDA tensors launch the Hopper kernel; CPU tensors take
    the plain version. `chamfer_bwd.launches` counts kernel launches."""
    _check_bwd(pred, gt, argp, argg)
    if pred.device.type == "cpu":
        return chamfer_bwd_plain(pred, gt, argp, argg)
    _kernels.check_device(pred)
    pred, gt, argp, argg = (t.contiguous() for t in (pred, gt, argp, argg))
    b, np_, _ = pred.shape
    ng = gt.shape[1]
    dpred, dgt = torch.empty_like(pred), torch.empty_like(gt)
    _kernels.launch(
        "vst_chamfer_bwd", pred.device,
        pred.data_ptr(), gt.data_ptr(), argp.data_ptr(), argg.data_ptr(),
        dpred.data_ptr(), dgt.data_ptr(), b, np_, ng,
    )
    chamfer_bwd.launches += 1
    return dpred, dgt


chamfer_bwd.launches = 0


class _PackedChamfer(torch.autograd.Function):
    """Forward from the packed keys (K4), backward through the argmins (K5)."""

    @staticmethod
    def forward(ctx, pred, gt, save):
        minp, argp, ming, argg = chamfer_nn_packed(pred, gt)
        if save:
            ctx.save_for_backward(pred, gt, argp, argg)
        return (minp.mean(dim=1) + ming.mean(dim=1)).mean()

    @staticmethod
    def backward(ctx, g):
        pred, gt, argp, argg = ctx.saved_tensors
        d_pred, d_gt = chamfer_bwd(pred, gt, argp, argg)
        return g * d_pred.to(pred.dtype), g * d_gt.to(gt.dtype), None


def chamfer_distance_packed(points_pred, points_gt):
    """Chamfer value from the packed keys (truncated by <= 2^-12 relative),
    differentiable through the argmins: the port of
    `chamfer_distance_pallas` and its custom VJP."""
    pred, gt = points_pred.float().contiguous(), points_gt.float().contiguous()
    save = torch.is_grad_enabled() and (pred.requires_grad or gt.requires_grad)
    return _PackedChamfer.apply(pred, gt, save)


def packed_chamfer_ok(b: int, n_pred: int, n_gt: int) -> bool:
    """The JAX package's shape gate for its packed Chamfer kernel
    (`best_chamfer`, chamfer.py:399-411, its TPU-backend check aside)."""
    return (b % _BB == 0 and n_pred % 128 == 0 and n_gt % 128 == 0
            and max(n_pred, n_gt) <= MAX_PACKED_N)


def best_chamfer(points_pred, points_gt):
    """`chamfer_distance_packed` (K4 forward, K5 backward) for CUDA
    clouds that pass `packed_chamfer_ok`, else the exact tiled path."""
    if points_pred.device.type == "cuda" and packed_chamfer_ok(
        points_pred.shape[0], points_pred.shape[1], points_gt.shape[1]
    ):
        return chamfer_distance_packed(points_pred, points_gt)
    return chamfer_distance(points_pred, points_gt)
