"""Sequence parallelism: the attention set models trained with the POINT
axis sharded over a 'seq' process group (port of
vae_song_tpu/parallel/sp.py).

A ('data', 'seq') DeviceMesh, 'seq' innermost (rank r sits at
(r // n_seq, r % n_seq)):

  * the batch axis is data-parallel, as in parallel/mesh.py;
  * the point axis of every cloud and activation is sharded over 'seq':
    self-attention gathers keys and values from the group, or rotates
    them round the ring with `ring` (ops/attention.py), the encoder's
    max-pool spans the group, the decoder decodes this rank's slice of
    its query embeddings and the Chamfer loss is the per-shard value
    (ops/chamfer.py:chamfer_sp). nn.sync.sequence_sharded switches the
    model into this mode for the step; its parameters and their names are
    its own, so checkpoints cross strategies.

The gradient convention is JAX's: each per-shard loss term is a mean over
equal shards (Chamfer) or computed identically on every shard of a row
(KL, latent recon: their inputs are replicated after the pool), so the
mean of the per-rank gradients over both mesh dimensions is the
single-device gradient of the row's batch, averaged over the rows. The
'seq' ranks of a row share one eps; only the 'data' rows draw apart
(JAX :92-94): the caller hands each rank its row's block of the noise
(mesh.shard_batch). Gradients, statistics and metrics are averaged over
both dimensions (JAX :98-104). No kernel runs under SP: the JAX package
routes `seq_axis` attention through its XLA einsums.
"""

import torch
import torch.distributed as dist

from vae_song_tpu_torch.nn.sync import sequence_sharded
from vae_song_tpu_torch.parallel import optree
from vae_song_tpu_torch.train.steps import _TERMS, make_backward_fn

SEQ_AXIS = "seq"


def make_sp_mesh(n_data: int, n_seq: int):
    """The ('data', 'seq') DeviceMesh of n_data x n_seq ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    from vae_song_tpu_torch.parallel.mesh import device_type

    return init_device_mesh(device_type(), (n_data, n_seq), mesh_dim_names=("data", SEQ_AXIS))


def shard_points(x: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's block of the global batch of clouds x [B, N, 3]: its
    'data' row's slice of the batch, its 'seq' index's slice of the
    points. Both must divide."""
    from vae_song_tpu_torch.parallel.mesh import shard_batch

    x = shard_batch(x, mesh)
    i, n = mesh.get_local_rank(SEQ_AXIS), _n_seq(mesh)
    if x.shape[1] % n:
        raise ValueError(f"{x.shape[1]} points do not divide over {n} 'seq' ranks")
    return x.narrow(1, i * (x.shape[1] // n), x.shape[1] // n)


def _n_seq(mesh) -> int:
    return mesh.size(mesh.mesh_dim_names.index(SEQ_AXIS))


def _validate(model, n_seq: int) -> None:
    """JAX :63-79: the attention set models, their points dividing over
    the n_seq 'seq' ranks. (`use_flash` is a no-op in the port.)"""
    from vae_song_tpu_torch.models.setvae import SetEncoderAttn

    if not isinstance(getattr(model, "encoder", None), SetEncoderAttn):
        raise NotImplementedError(
            "sequence parallelism supports the attention set models only"
        )
    if model.num_points % n_seq != 0:
        raise ValueError(
            f"num_points={model.num_points} must divide evenly over the "
            f"'seq' axis ({n_seq} shards)"
        )


def _mesh_mean(tensors, mesh) -> None:
    """Average `tensors` (plain, one dtype) over every rank of the mesh,
    in place: one all-reduce a mesh dimension."""
    for dim in mesh.mesh_dim_names:
        group = mesh.get_group(dim)
        optree._coalesced_mean(tensors, group, dist.get_world_size(group))


def make_sp_train_step(model, optimizer, mesh, ring: bool = False,
                       grad_mode: str | None = None):
    """DP x SP train step on a ('data', 'seq') mesh (JAX :82):
    step(x, eps, wu_alpha, dropout_rng=None) -> the metrics averaged over
    the mesh, x this rank's block (`shard_points`), eps its row's block
    of the noise. `ring` takes the ring attention instead of the
    all-gather. The gradients are averaged over the mesh, then
    `optimizer` (its clip sees the replicated gradients, the
    single-device clip) takes one update."""
    _validate(model, _n_seq(mesh))
    seq = mesh.get_group(SEQ_AXIS)
    params = [p for p in optimizer.params if p.requires_grad]

    def mean():
        grads = [p.grad for p in params if p.grad is not None]
        for dtype in {g.dtype for g in grads}:
            _mesh_mean([g for g in grads if g.dtype == dtype], mesh)

    backward_fn = make_backward_fn(model, model, params, grad_mode,
                                   after_backward=torch.no_grad()(mean))

    def step(x, eps, wu_alpha=0.0, dropout_rng=None):
        with sequence_sharded(seq, ring):
            m = backward_fn(x, eps, wu_alpha, dropout_rng)
        with torch.no_grad():
            bufs = [b for b in model.buffers() if b.is_floating_point()]
            if bufs:
                _mesh_mean(bufs, mesh)
            _mesh_mean([m], mesh)
        optimizer.step()
        return dict(zip(_TERMS, m.unbind()))

    return step


def make_sp_eval_step(model, mesh, ring: bool = False):
    """DP x SP eval step (JAX :131): eval(x, eps, wu_alpha) -> {"loss",
    "recon", "reg", "lr"} averaged over the mesh."""
    _validate(model, _n_seq(mesh))
    seq = mesh.get_group(SEQ_AXIS)

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.no_grad(), sequence_sharded(seq, ring):
            outs = model(x, eps)
            m = torch.stack(model.loss(x, *outs, wu_alpha=wu_alpha)).float()
            _mesh_mean([m], mesh)
        return dict(zip(("loss", "recon", "reg", "lr"), m.unbind()))

    return eval_step
