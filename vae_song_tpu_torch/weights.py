"""The one map between the JAX package's Flax variable trees (nested
dicts of numpy arrays, as `save_params_only` pickles them) and the port's
`state_dict`, in both directions.

  * Flax Dense `kernel [in, out]` <-> Linear-shaped `weight [out, in]`,
    `bias` as is. vae_song_tpu.nn.blocks.Dense nests an nn.Dense named
    Dense_0, so those leaves sit one level deeper than the MHA ones; the
    JAX Conv wrapper nests an nn.Conv named Conv_0 the same way.
  * Flax Conv `kernel [kh, kw, in, out]` <-> Conv2d-shaped
    `weight [out, in, kh, kw]`.
  * Flax ConvTranspose `kernel [kh, kw, in, out]` <-> ConvTranspose2d-
    shaped `weight [in, out, kh, kw]`, flipped in both spatial axes (Flax
    convolves with the kernel as it is, torch's transposed convolution
    with it flipped).
  * LayerNorm `scale` <-> `weight`, `bias` as is.
  * BatchNorm (vae_song_tpu.nn.blocks.BatchNorm nests an nn.BatchNorm
    named BatchNorm_0): `params` `scale` / `bias` <-> `weight` / `bias`,
    and the `batch_stats` collection's `mean` / `var` <-> the buffers
    `running_mean` / `running_var`.
  * `decoder/query_embed` and `decoder/point_queries` as is.
  * The MoE FFN (nn/moe.py): `router`, `w1`, `b1`, `w2`, `b2` as they are
    (JAX's stacked layout, not Dense kernels), under the encoder layer's
    `MoEFFN_0` and the decoder layer's `moe_ffn`.
  * LIDVAE's ICNNs: `icnn{1,2}.dense.i` <-> `icnn{1,2}/Dense_i/Dense_0` and
    `icnn{1,2}.positive.i` <-> `icnn{1,2}/PositiveLinear_i`, whose raw
    `kernel [in, out]` is the port's Linear-shaped `weight [out, in]`
    (no bias).

Each rule maps a port module path to its Flax path; the conversion
refuses leaves that no rule names, so a tree from a model the port does
not build fails loudly instead of loading partly. A tree shaped
like the parameters (Adam's moments in optax's state) goes through the
same map.
"""

import re

import numpy as np
import torch

_ENC = r"encoder/TransformerEncoderLayer_\1"
_DEC = r"decoder/TransformerDecoderLayer_\1"
# (port module path, Flax module path, kind)
_RULES = [
    (r"encoder\.embed", "encoder/Dense_0/Dense_0", "dense"),
    (r"encoder\.layers\.(\d+)\.self_attn\.(query|key|value|out)",
     _ENC + r"/MultiHeadAttention_0/\2", "dense"),
    (r"encoder\.layers\.(\d+)\.norm1", _ENC + "/LayerNorm_0", "norm"),
    (r"encoder\.layers\.(\d+)\.ff_up", _ENC + "/Dense_0/Dense_0", "dense"),
    (r"encoder\.layers\.(\d+)\.ff_down", _ENC + "/Dense_1/Dense_0", "dense"),
    (r"encoder\.layers\.(\d+)\.norm2", _ENC + "/LayerNorm_1", "norm"),
    (r"encoder\.fc_mu", "encoder/Dense_1/Dense_0", "dense"),
    (r"encoder\.fc_logvar", "encoder/Dense_2/Dense_0", "dense"),
    (r"decoder\.memory", "decoder/Dense_0/Dense_0", "dense"),
    (r"decoder\.layers\.(\d+)\.(self_attn|cross_attn)\.(query|key|value|out)",
     _DEC + r"/\2/\3", "dense"),
    (r"decoder\.layers\.(\d+)\.(norm[123])", _DEC + r"/\2", "norm"),
    (r"decoder\.layers\.(\d+)\.(ff_up|ff_down)", _DEC + r"/\2/Dense_0", "dense"),
    (r"decoder\.out", "decoder/Dense_1/Dense_0", "dense"),
    # the MoE FFN (nn/moe.py)
    (r"encoder\.layers\.(\d+)\.moe_ffn", _ENC + "/MoEFFN_0", "moe"),
    (r"decoder\.layers\.(\d+)\.moe_ffn", _DEC + "/moe_ffn", "moe"),
    # the DeepSets SetEncoder / SetDecoder
    (r"(encoder|decoder)\.dense\.(\d+)", r"\1/Dense_\2/Dense_0", "dense"),
    (r"(encoder|decoder)\.norm\.(\d+)", r"\1/BatchNorm_\2/BatchNorm_0", "batchnorm"),
    # the FlexibleVAE encoders and decoders (models/flexible.py)
    (r"(encoder|decoder)\.mlp\.(\d+)\.dense", r"\1/MLPBlock_\2/Dense_0/Dense_0", "dense"),
    (r"(encoder|decoder)\.mlp\.(\d+)\.norm", r"\1/MLPBlock_\2/BatchNorm_0/BatchNorm_0",
     "batchnorm"),
    (r"(encoder|decoder)\.res_mlp\.(\d+)\.dense\.(\d+)",
     r"\1/ResidualMLPBlock_\2/Dense_\3/Dense_0", "dense"),
    (r"(encoder|decoder)\.res_mlp\.(\d+)\.norm\.(\d+)",
     r"\1/ResidualMLPBlock_\2/BatchNorm_\3/BatchNorm_0", "batchnorm"),
    (r"(encoder|decoder)\.res_conv\.(\d+)\.conv\.(\d+)",
     r"\1/ResidualConvBlock_\2/Conv_\3/Conv_0", "conv"),
    (r"(encoder|decoder)\.res_conv\.(\d+)\.norm\.(\d+)",
     r"\1/ResidualConvBlock_\2/BatchNorm_\3/BatchNorm_0", "batchnorm"),
    (r"(encoder|decoder)\.head", r"\1/Dense_0/Dense_0", "dense"),
    (r"decoder\.up\.(\d+)\.conv", r"decoder/UpConv_\1/ConvTranspose_0", "conv_transpose"),
    (r"decoder\.up\.(\d+)\.norm", r"decoder/BatchNorm_\1/BatchNorm_0", "batchnorm"),
    (r"decoder\.out_conv", "decoder/Conv_0", "conv"),
    # LIDVAE's ICNNs (nn/blocks.py:ICNN)
    (r"(icnn[12])\.dense\.(\d+)", r"\1/Dense_\2/Dense_0", "dense"),
    (r"(icnn[12])\.positive\.(\d+)", r"\1/PositiveLinear_\2", "dense"),
]
# leaf name -> (Flax collection, Flax leaf name)
_PARAMS = {"weight": ("params", "kernel"), "bias": ("params", "bias")}
_LEAF = {"dense": _PARAMS, "conv": _PARAMS, "conv_transpose": _PARAMS,
         "norm": {"weight": ("params", "scale"), "bias": ("params", "bias")},
         "moe": {name: ("params", name) for name in ("router", "w1", "b1", "w2", "b2")},
         "batchnorm": {"weight": ("params", "scale"), "bias": ("params", "bias"),
                       "running_mean": ("batch_stats", "mean"),
                       "running_var": ("batch_stats", "var")}}
# the weight's layout change, Flax -> port and port -> Flax
_TO_PORT = {"dense": lambda a: a.T,
            "conv": lambda a: a.transpose(3, 2, 0, 1),
            "conv_transpose": lambda a: a[::-1, ::-1].transpose(2, 3, 0, 1)}
_TO_FLAX = {"dense": lambda a: a.T,
            "conv": lambda a: a.transpose(2, 3, 1, 0),
            "conv_transpose": lambda a: a.transpose(2, 3, 0, 1)[::-1, ::-1]}
_PLAIN = {"decoder.query_embed", "decoder.point_queries"}
COLLECTIONS = ("params", "batch_stats")


def flax_path(key: str) -> tuple[str, tuple[str, ...], str | None]:
    """(Flax collection, path in it, the weight's layout kind: "dense",
    "conv", "conv_transpose" or None for a leaf kept as it is) of one port
    state_dict key. Exactly one rule may claim a key."""
    if key in _PLAIN:
        return "params", tuple(key.split(".")), None
    module, _, leaf = key.rpartition(".")
    found = []
    for pattern, template, kind in _RULES:
        m = re.fullmatch(pattern, module)
        if m and leaf in _LEAF[kind]:
            collection, name = _LEAF[kind][leaf]
            path = m.expand(template).split("/") + [name]
            layout = kind if leaf == "weight" and kind in _TO_PORT else None
            found.append((collection, tuple(path), layout))
    if len(found) > 1:
        raise KeyError(f"port parameter {key!r} matches {len(found)} rules: {found}")
    if not found:
        raise KeyError(f"no Flax counterpart for port parameter {key!r}")
    return found[0]


def _flatten(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def params_to_state_dict(params: dict, keys, batch_stats: dict | None = None
                         ) -> dict[str, torch.Tensor]:
    """Flax params (and batch_stats) -> float32 tensors for those port
    keys `keys` (e.g. `model.state_dict().keys()`) whose collection is
    given: without `batch_stats` only the params' keys are converted.
    Raises on a missing or unused leaf."""
    trees = {"params": params, "batch_stats": batch_stats}
    leaves = {c: dict(_flatten(t)) for c, t in trees.items() if t is not None}
    out, used = {}, {c: set() for c in leaves}
    for key in keys:
        collection, path, layout = flax_path(key)
        if collection not in leaves:
            continue
        if path not in leaves[collection]:
            raise KeyError(f"Flax {collection} has no {'/'.join(path)} for {key!r}")
        arr = np.asarray(leaves[collection][path], dtype=np.float32)
        out[key] = torch.tensor(np.ascontiguousarray(_TO_PORT[layout](arr) if layout else arr))
        used[collection].add(path)
    unused = sorted(f"{c}:{'/'.join(p)}" for c in leaves for p in leaves[c].keys() - used[c])
    if unused:
        raise KeyError(f"Flax leaves with no port counterpart: {unused[:8]}")
    return out


def state_dict_to_variables(state_dict) -> dict[str, dict]:
    """Port state_dict -> {"params": ..., "batch_stats": ...}, nested Flax
    trees of float32 numpy arrays ({} where the model has none)."""
    trees: dict = {c: {} for c in COLLECTIONS}
    for key, t in state_dict.items():
        collection, path, layout = flax_path(key)
        arr = t.detach().float().cpu().numpy()
        node = trees[collection]
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(_TO_FLAX[layout](arr) if layout else arr)
    return trees


def state_dict_to_params(state_dict) -> dict:
    """Port state_dict -> nested Flax params of float32 numpy arrays."""
    return state_dict_to_variables(state_dict)["params"]


def load_flax_params(model: torch.nn.Module, params: dict,
                     batch_stats: dict | None = None) -> torch.nn.Module:
    """Copy a Flax parameter tree, and the BatchNorm statistics, into
    `model` (on whatever device it is). A model with BatchNorm layers
    needs `batch_stats`; every key of the model must be loaded."""
    keys = model.state_dict().keys()
    model.load_state_dict(params_to_state_dict(params, keys, batch_stats))
    return model
