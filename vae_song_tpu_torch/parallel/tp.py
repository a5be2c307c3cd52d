"""Tensor parallelism for the attention set models (port of
vae_song_tpu/parallel/tp.py), with DTensor (`parallelize_module`) over
the mesh's 'model' dimension:

  * attention query/key/value projections: column-wise (their output
    features, the heads, split over 'model'; the bias split with them);
  * attention out projection: row-wise (its input features split; the
    partial products all-reduced; the bias whole);
  * FFN up: column-wise; FFN down: row-wise;
  * everything else replicated; the batch on 'data'.

Megatron-style: each rank computes its own heads and FFN columns, with
one all-reduce after each row-wise projection in the forward and one on
the input's gradient before each column-wise projection in the backward.
The projections hand the attention plain local tensors, so the attention
(ops/attention.py) takes its local head count from their width and picks
its route, and its kernels, for the local heads. The rule is structural
(`_dense_specs`): by the projection's role and its weight's shape, the
module path breaking only the tie of a square FFN's up and down
projections.

The port's Dense is not an nn.Linear, so the plan uses its own two
ParallelStyles, built from DTensor's public `distribute_module`.
"""

import torch
from torch import nn

from vae_song_tpu_torch.ops.attention import _fused_qkv_on
from vae_song_tpu_torch.parallel import optree
from vae_song_tpu_torch.parallel.mesh import replicate_state
from vae_song_tpu_torch.train.state import TrainState

_ATTN_ROLES = ("query", "key", "value")
_LAYER_TOKENS = ("TransformerEncoderLayer", "TransformerDecoderLayer")
COLWISE, ROWWISE = ("model", None), (None, "model")


def _dense_specs(path: tuple, weight_shape, in_transformer_layer: bool,
                 in_attention: bool = True, d_model: int | None = None):
    """Structural rule for one Dense-like module (a `weight` [out, in] and
    a `bias`): (weight spec, bias spec) as tuples over the port axes,
    "model" on the split axis, () for whole (JAX :29-66). The role names
    count inside an attention module only: the port's set decoder also
    calls its last projection `out`. Given the layer's width `d_model`,
    an FFN projection that reads it is the up one and one that writes it
    the down one: JAX's rule (up = more outputs than inputs) swaps the
    two when ff_dim < d_model, which GSPMD partitions correctly either
    way but a column-wise / row-wise pairing does not."""
    module_name = str(path[-1]) if path else ""
    if in_attention and module_name in _ATTN_ROLES:
        return COLWISE, ("model",)
    if in_attention and module_name == "out":
        return ROWWISE, ()
    if in_transformer_layer and len(weight_shape) == 2:
        d_out, d_in = weight_shape
        if d_model is not None and d_out != d_in:
            if d_in == d_model:
                return COLWISE, ("model",)
            if d_out == d_model:
                return ROWWISE, ()
        if d_out > d_in:  # FFN up [ff, d_model]: rows (its outputs) and bias split
            return COLWISE, ("model",)
        if d_in > d_out:  # FFN down [d_model, ff]: columns split, bias whole
            return ROWWISE, ()
        # square (ff_dim == d_model): the names break the tie, 'down'
        # first, as in JAX (whose down path also holds a Dense_0 token)
        hint = "/".join(str(p).lower() for p in path[-2:])
        parent = str(path[-2]).lower() if len(path) >= 2 else ""
        if "down" in hint or parent.startswith("dense_1"):
            return ROWWISE, ()
        if "up" in hint or parent.startswith("dense_0"):
            return COLWISE, ("model",)
    return (), ()


def _module_specs(model: nn.Module) -> tuple[dict, list]:
    """({parameter name: spec} for every parameter, [the transformer
    layers' module names])."""
    classes = {name: type(m).__name__ for name, m in model.named_modules()}
    layers = [name for name, cls in classes.items() if cls in _LAYER_TOKENS]
    specs = {name: () for name, _ in model.named_parameters()}
    for name, m in model.named_modules():
        w = getattr(m, "weight", None)
        if not isinstance(w, torch.Tensor) or w.dim() != 2 or "weight" not in m._parameters:
            continue
        path = tuple(name.split(".")) if name else ()
        layer = next((la for la in layers if name.startswith(la + ".")), None)
        norm = getattr(model.get_submodule(layer), "norm1", None) if layer is not None else None
        width = norm.weight.shape[0] if norm is not None else None
        parent = classes.get(name.rpartition(".")[0], "")
        wspec, bspec = _dense_specs(path, tuple(w.shape), layer is not None,
                                    parent == "MultiHeadAttention", width)
        prefix = name + "." if name else ""
        specs[prefix + "weight"] = wspec
        if prefix + "bias" in specs:
            specs[prefix + "bias"] = bspec
    return specs, layers


def check_tp_coverage(specs: dict, layers) -> None:
    """Invariant: every transformer layer holds >= 1 'model'-split
    parameter; a refactor that moves submodules out of the structural
    rules fails here instead of training replicated."""
    unsharded = sorted(layer for layer in layers
                       if not any(k.startswith(layer + ".") and "model" in s
                                  for k, s in specs.items()))
    if unsharded:
        raise ValueError(
            "TP spec mapping produced zero 'model'-sharded params for "
            f"transformer layer(s) {unsharded}; the structural rules in "
            "parallel/tp.py no longer match this parameter tree"
        )


def setvae_param_specs(model: nn.Module, check: bool = True) -> dict:
    """{parameter name: spec} of a SetVAE / SetLRVAE (the tuples of
    `_dense_specs`)."""
    specs, layers = _module_specs(model)
    if check:
        check_tp_coverage(specs, layers)
    return specs


def _styles():
    """The column-wise and row-wise ParallelStyles for the port's Dense."""
    from torch.distributed.tensor import (DTensor, Replicate, Shard, distribute_module,
                                          distribute_tensor)
    from torch.distributed.tensor.parallel import ParallelStyle

    def place(module, mesh, placements):
        for n, p in list(module.named_parameters(recurse=False)):
            module.register_parameter(
                n, nn.Parameter(distribute_tensor(p.data, mesh, [placements[n]])))

    class DenseColwise(ParallelStyle):
        """Weight rows (output features) and bias split; the replicated
        input enters as a Replicate DTensor (its gradient all-reduced in
        the backward); the output leaves as this rank's local columns."""

        def _apply(self, module, mesh):
            return distribute_module(
                module, mesh,
                lambda _n, m, mesh: place(m, mesh, {"weight": Shard(0), "bias": Shard(0)}),
                lambda _m, inputs, mesh: (DTensor.from_local(inputs[0], mesh, [Replicate()],
                                                             run_check=False),),
                lambda _m, out, mesh: out.to_local())

    class DenseRowwise(ParallelStyle):
        """Weight columns (input features) split, bias whole; the input is
        this rank's local columns; the partial products are all-reduced
        into a replicated output."""

        def _apply(self, module, mesh):
            return distribute_module(
                module, mesh,
                lambda _n, m, mesh: place(m, mesh, {"weight": Shard(1), "bias": Replicate()}),
                lambda _m, inputs, mesh: (DTensor.from_local(inputs[0], mesh, [Shard(-1)],
                                                             run_check=False),),
                lambda _m, out, mesh: out.redistribute(mesh, [Replicate()]).to_local())

    return DenseColwise, DenseRowwise


def parallelize(model: nn.Module, mesh) -> nn.Module:
    """Apply the plan of `setvae_param_specs` over the mesh's 'model'
    dimension (in place)."""
    from torch.distributed.tensor.parallel import parallelize_module

    colwise, rowwise = _styles()
    plan = {}
    for name, spec in setvae_param_specs(model).items():
        if name.endswith(".weight") and spec in (COLWISE, ROWWISE):
            plan[name[: -len(".weight")]] = colwise() if spec == COLWISE else rowwise()
    return parallelize_module(model, mesh["model"], plan)


def shard_state(state: TrainState, mesh) -> TrainState:
    """The model parallelized on the mesh's 'model' dimension, Adam's
    moments split like their parameters: the first rank's state
    (mesh.replicate_state), since the replicated parameters are never
    synchronised after it."""
    replicate_state(state, mesh)
    slots = optree.optimizer_slots(state)
    parallelize(state.model, mesh)
    return optree.shard_opt_state(state, slots)


def check_flash_partitionable(model, mesh) -> None:
    """The port's gate for a 'model'-split mesh (JAX :152). The JAX gate
    refuses `use_flash` models whose attention would take the tiled flash
    kernel GSPMD cannot partition; the port has no such kernel
    (`use_flash` is a no-op, ROADMAP Queue 2) and its dense kernels run
    on each rank's local heads. What it refuses is VST_FUSED_QKV=1, whose
    one [d, 3d] product over the concatenated projections would cut the
    heads at other places than the column-wise plan does. VST_FUSED_FFN=1
    runs: each rank computes the whole FFN on the gathered weights, as
    GSPMD computes the JAX kernel, which has no partition rule."""
    if "model" in (mesh.mesh_dim_names or ()) and _fused_qkv_on():
        raise ValueError(
            "VST_FUSED_QKV=1 under tensor parallelism: the fused [d, 3d] "
            "in-projection does not follow the column-wise head split; unset it "
            "for TP meshes (the three projections shard transparently)."
        )


def make_tp_dp_train_step(model, optimizer, mesh, grad_mode: str | None = None):
    """Train step on a ('data', 'model') mesh: batch on 'data', heads and
    FFN columns on 'model' (optree.make_gspmd_train_step; every gradient
    averaged over 'data' by one all-reduce)."""
    check_flash_partitionable(model, mesh)
    return optree.make_gspmd_train_step(model, optimizer, mesh, (), grad_mode)

