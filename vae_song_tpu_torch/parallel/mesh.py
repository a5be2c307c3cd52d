"""Process groups, device meshes and the data-parallel step (port of
vae_song_tpu/parallel/mesh.py).

One process per device, launched by `torchrun`: `init_multihost` opens
the process group from torchrun's environment (NCCL on the card, gloo on
the CPU) and the rank takes the place of `jax.process_index()`.
`make_mesh` builds a 1-D ('data',) or 2-D ('data', 'model')
torch DeviceMesh over the ranks.

Data parallelism keeps the JAX step's semantics exactly: each rank takes
its contiguous slice of the global batch (`shard_batch`) and computes the
loss and gradients of its shard; the gradients are averaged over the
ranks (torch's DistributedDataParallel reduces them in its backward
hooks), each shard's updated BatchNorm statistics are averaged (so DDP's
`broadcast_buffers` is off: it would copy rank 0's), and the metrics are
averaged. Loss terms that sum over the batch (FlexibleVAE's latent-recon
term) are summed over the shard and then averaged: the DDP convention,
under which DP over n ranks of a global batch B matches one device's
batch of B / n. The JAX step folds the rank into its key; the port's
noise stays an input, and the caller hands each rank its block of the
global batch's noise (`shard_batch` on eps).
"""

import datetime
import os
import socket

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from vae_song_tpu_torch.train.state import TrainState
from vae_song_tpu_torch.train.steps import _TERMS, _mode, make_backward_fn


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def init_multihost(backend: str | None = None, timeout_s: float = 600.0) -> tuple[int, int]:
    """Open the default process group, one process per device; returns
    (rank, world size). Under `torchrun` the rank, world size and
    rendezvous come from its environment (RANK, WORLD_SIZE, LOCAL_RANK,
    MASTER_ADDR, MASTER_PORT); without it a one-process group on a free
    localhost port. backend: NCCL when a CUDA card is visible, else gloo.
    On the card each process takes cuda:LOCAL_RANK as its current device.
    An already open group is returned as it is. A failure raises."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    rank = int(os.environ.get("RANK", 0))
    world = int(os.environ.get("WORLD_SIZE", 1))
    if "MASTER_ADDR" not in os.environ:
        os.environ["MASTER_ADDR"] = "localhost"
        os.environ["MASTER_PORT"] = str(_free_port())
    cuda = torch.cuda.is_available()
    if backend is None:
        backend = "nccl" if cuda else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    dist.init_process_group(backend, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world


def device_type() -> str:
    """The device type of the open process group's ranks."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_data: int | None = None, n_model: int = 1):
    """A ('data',) DeviceMesh over every rank, or with n_model > 1 a
    ('data', 'model') one of n_data x n_model ranks (n_data defaults to
    the world size // n_model); rank r sits at (r // n_model,
    r % n_model)."""
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} ranks; "
                         f"the process group has {world}")
    if n_model == 1:
        return init_device_mesh(device_type(), (n_data,), mesh_dim_names=("data",))
    return init_device_mesh(device_type(), (n_data, n_model), mesh_dim_names=("data", "model"))


def data_coordinate(mesh, axis: str = "data") -> tuple[int, int]:
    """(this rank's index on `axis`, the size of `axis`); (0, 1) for a mesh
    without that dimension (the batch is not split)."""
    if axis not in (mesh.mesh_dim_names or ()):
        return 0, 1
    return mesh.get_local_rank(axis), mesh.size(mesh.mesh_dim_names.index(axis))


@torch.no_grad()
def replicate_state(state: TrainState, mesh) -> TrainState:
    """The first rank's parameters, BatchNorm statistics and Adam moments
    broadcast to every rank of the mesh, one mesh dimension after the
    other (JAX: the replicated placement). Every strategy starts from it,
    so ranks that drew their weights apart still train one model. The
    state must not be sharded yet."""
    adam = state.optimizer.adam
    tensors = [*state.model.parameters(), *state.model.buffers(), *adam.mu, *adam.nu]
    for dim in mesh.mesh_dim_names:
        group = mesh.get_group(dim)
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t.data, src, group=group)
    return state


def shard_batch(x: torch.Tensor, mesh, dim: int = 0, axis: str = "data") -> torch.Tensor:
    """This rank's contiguous slice, along `dim`, of the global batch `x`
    (the same tensor on every rank): slice i of n for the rank at index i
    on the mesh dimension `axis` ('data'; 'expert' under expert
    parallelism), in the global order; `x` whole without that dimension.
    The batch must divide by n."""
    i, n = data_coordinate(mesh, axis)
    b = x.shape[dim]
    if b % n:
        raise ValueError(f"a batch of {b} does not divide over {n} '{axis}' ranks")
    return x.narrow(dim, i * (b // n), b // n)


def _mean_over(t: torch.Tensor, group, n: int) -> torch.Tensor:
    dist.all_reduce(t, group=group)
    return t.div_(n)


def make_dp_train_step(model, optimizer, mesh, grad_mode: str | None = None):
    """Data-parallel train step over the mesh's 'data' group:
    step(x, eps, wu_alpha, dropout_rng=None) -> the metrics averaged over
    the ranks, x and eps this rank's shard (`shard_batch`). The model is
    wrapped in DistributedDataParallel (broadcast_buffers off); its
    reducer averages the gradients in the backward. The composite
    gradient's graph is the same every step (the decoder's kv-length-1
    cross-attention leaves the same query/key projections unused), so
    DDP takes it as static and searches for unused parameters only once;
    the staged gradient's two passes reach different parameters, so DDP
    searches each pass. The shards' new BatchNorm statistics are averaged
    after it, then `optimizer` (its clip sees the replicated gradients,
    the single-device clip) takes one update."""
    from torch.nn.parallel import DistributedDataParallel

    group = mesh.get_group("data")
    n = dist.get_world_size(group)
    static = _mode(model, grad_mode) == "composite"
    ddp = DistributedDataParallel(model, process_group=group, broadcast_buffers=False,
                                  find_unused_parameters=not static, static_graph=static)
    params = [p for p in optimizer.params if p.requires_grad]
    backward_fn = make_backward_fn(ddp, model, params, grad_mode)

    def step(x, eps, wu_alpha=0.0, dropout_rng=None):
        m = backward_fn(x, eps, wu_alpha, dropout_rng)
        with torch.no_grad():
            for b in model.buffers():
                if b.is_floating_point():
                    _mean_over(b, group, n)
            m = _mean_over(m, group, n)
        optimizer.step()
        return dict(zip(_TERMS, m.unbind()))

    return step


def make_dp_eval_step(model, mesh):
    """Data-parallel eval step: eval(x, eps, wu_alpha) -> {"loss",
    "recon", "reg", "lr"} of this rank's shard (running BatchNorm
    statistics), averaged over the 'data' group."""
    group = mesh.get_group("data")
    n = dist.get_world_size(group)

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.no_grad():
            outs = model(x, eps)
            m = _mean_over(torch.stack(model.loss(x, *outs, wu_alpha=wu_alpha)).float(),
                           group, n)
        return dict(zip(("loss", "recon", "reg", "lr"), m.unbind()))

    return eval_step
