"""FSDP / ZeRO-3 parameter and optimizer sharding over 'data' (port of
vae_song_tpu/parallel/fsdp.py), with torch's FSDP2 (`fully_shard`).

Every large parameter is split along one axis over the same 'data' ranks
the batch is split over; its Adam moments are split like it
(optree.shard_opt_state). FSDP2 all-gathers the parameters for the
forward and the backward and reduce-scatters (averages) the gradients.
The step is optree.make_gspmd_train_step, the single-device step with
global-batch semantics, so every model family trains under FSDP,
BatchNorm included: the statistics are the global batch's (Flax's
E[x^2] - E[x]^2, the biased variance in the running buffers) and the
batch-summed latent-recon term is not divided by the rank count.

Placement rule (JAX :45-56), on the parameter's Flax layout (a Dense
weight [out, in] is the kernel [in, out]; vae_song_tpu_torch.weights):
a leaf under `min_shard_elems` elements stays whole, any other is split
on its largest axis divisible by the shard count, ties to the last axis,
and a leaf no axis of which divides stays whole. FSDP2 shards every
parameter it manages, so a leaf that stays whole is kept out of it
(`ignored_params`) and its gradient is averaged by the step's
all-reduce. The whole model is one FSDP2 unit (fully_shard on the root):
the set decoder calls its first layer by halves, outside the layer's
forward, where a per-layer unit would not have gathered its parameters.
"""

import torch

from vae_song_tpu_torch import weights
from vae_song_tpu_torch.parallel import optree
from vae_song_tpu_torch.parallel.mesh import make_mesh, replicate_state
from vae_song_tpu_torch.train.state import TrainState

# 16k elements = 64 KiB f32: below this, the per-use all-gather dispatch
# outweighs the per-device memory saved
DEFAULT_MIN_SHARD_ELEMS = 2 ** 14

# port axis -> Flax axis of each weight layout (weights.py)
_FLAX_AXIS = {"dense": (1, 0), "conv": (3, 2, 0, 1), "conv_transpose": (2, 3, 0, 1)}


def make_fsdp_mesh(n_shards: int | None = None):
    """A ('data',) mesh of n_shards ranks (all of them by default)."""
    return make_mesh(n_shards, 1)


def _flax_axes(name: str, ndim: int) -> tuple:
    """Flax axis of each axis of port parameter `name` (identity for a
    name weights.py does not map)."""
    try:
        layout = weights.flax_path(name)[2]
    except KeyError:
        layout = None
    return _FLAX_AXIS.get(layout, tuple(range(ndim)))


def _leaf_axis(name: str, shape, n_shards: int, min_shard_elems: int, taken=()):
    """The port axis the rule splits `name` on over n_shards, or None.
    `taken`: axes already split (by tensor parallelism)."""
    if int(torch.Size(shape).numel()) < min_shard_elems:
        return None
    flax = _flax_axes(name, len(shape))
    divisible = [(d, flax[i], i) for i, d in enumerate(shape)
                 if i not in taken and d % n_shards == 0]
    if not divisible:
        return None
    # largest axis first; ties broken toward the LAST Flax axis
    return max(divisible)[2]


def _spec(ndim: int, axes: dict) -> tuple:
    spec = [None] * ndim
    for i, name in axes.items():
        spec[i] = name
    return tuple(spec) if any(a is not None for a in spec) else ()


def fsdp_param_specs(shapes: dict, n_shards: int,
                     min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> dict:
    """{name: spec} for {name: shape}: the spec a tuple over the port
    axes, "data" on the split axis, () for a leaf kept whole (JAX
    P(...) / P())."""
    out = {}
    for name, shape in shapes.items():
        i = _leaf_axis(name, shape, n_shards, min_shard_elems)
        out[name] = _spec(len(shape), {} if i is None else {i: "data"})
    return out


def param_shapes(model) -> dict:
    return {name: tuple(p.shape) for name, p in model.named_parameters()}


def sharded_fraction(model, n_shards: int,
                     min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> float:
    """Share of the parameter ELEMENTS that the rule splits; the memory a
    rank saves is about this x (1 - 1/n) x 3 (parameters, mu, nu)."""
    shapes = param_shapes(model)
    specs = fsdp_param_specs(shapes, n_shards, min_shard_elems)
    tot = sum(torch.Size(s).numel() for s in shapes.values())
    shd = sum(torch.Size(shapes[k]).numel() for k, s in specs.items() if s)
    return shd / max(tot, 1)


def merge_tp_fsdp_specs(shapes: dict, tp_specs: dict, n_data: int,
                        min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> dict:
    """Compose the tensor-parallel specs (parallel/tp.py) with FSDP: each
    leaf keeps its 'model' axis and, when large enough, also splits its
    largest FREE axis over 'data' (JAX :136-162)."""
    out = {}
    for name, shape in shapes.items():
        tspec = tuple(tp_specs.get(name, ())) + (None,) * (len(shape) - len(tp_specs.get(name, ())))
        axes = {i: a for i, a in enumerate(tspec) if a is not None}
        i = _leaf_axis(name, shape, n_data, min_shard_elems, taken=tuple(axes))
        if i is not None:
            axes[i] = "data"
        out[name] = _spec(len(shape), axes)
    return out


def _fully_shard(state: TrainState, mesh, specs: dict) -> TrainState:
    """fully_shard the model over the mesh's 'data' dimension as `specs`
    say (the leaves without "data" kept out of FSDP2), then lay the
    optimizer's moments out like the parameters."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    model = state.model
    slots = optree.optimizer_slots(state)
    axis = {id(p): specs[name].index("data") for name, p in model.named_parameters()
            if "data" in specs[name]}
    ignored = {p for p in model.parameters() if id(p) not in axis}
    # reshard after the forward too: FSDP2 keeps a root unit's parameters
    # gathered after its forward otherwise, which would hold the whole
    # model on every rank between steps
    fully_shard(model, mesh=mesh["data"] if mesh.ndim > 1 else mesh,
                reshard_after_forward=True,
                shard_placement_fn=lambda p: Shard(axis[id(p)]),
                ignored_params=ignored or None)
    state.fsdp_params = [p for name, p in model.named_parameters() if "data" in specs[name]]
    return optree.shard_opt_state(state, slots)


def shard_state(state: TrainState, mesh,
                min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> TrainState:
    """The model under FSDP2 over the ('data',) mesh with the placement
    rule, Adam's moments split like their parameters: the first rank's
    state (mesh.replicate_state), as each rank shards its own copy."""
    n = mesh.size(mesh.mesh_dim_names.index("data"))
    replicate_state(state, mesh)
    return _fully_shard(state, mesh,
                        fsdp_param_specs(param_shapes(state.model), n, min_shard_elems))


def shard_state_tp_fsdp(state: TrainState, mesh,
                        min_shard_elems: int = DEFAULT_MIN_SHARD_ELEMS) -> TrainState:
    """2-D weight sharding on a ('data', 'model') mesh: the tensor-parallel
    plan on 'model' (tp.shard_state, from the first rank's state), then
    FSDP2 over 'data' on each large leaf's largest free axis."""
    from vae_song_tpu_torch.parallel import tp

    shapes = param_shapes(state.model)
    tp_specs = tp.setvae_param_specs(state.model)
    state = tp.shard_state(state, mesh)
    merged = merge_tp_fsdp_specs(shapes, tp_specs, mesh.size(0), min_shard_elems)
    return _fully_shard(state, mesh, merged)


def make_fsdp_train_step(model, optimizer, mesh, fsdp_params, grad_mode: str | None = None):
    """The FSDP train step (optree.make_gspmd_train_step): x and eps this
    rank's slice of the global batch, the metrics the global batch's."""
    return optree.make_gspmd_train_step(model, optimizer, mesh, fsdp_params, grad_mode)


def make_tp_fsdp_train_step(model, optimizer, mesh, fsdp_params, grad_mode: str | None = None):
    """The TP x FSDP train step on a ('data', 'model') mesh: batch on
    'data', heads and FFN columns on 'model', large leaves also on
    'data' with their Adam moments."""
    from vae_song_tpu_torch.parallel.tp import check_flash_partitionable

    check_flash_partitionable(model, mesh)
    return optree.make_gspmd_train_step(model, optimizer, mesh, fsdp_params, grad_mode)
