"""The one map between the JAX package's Flax parameter tree (nested
dicts of numpy arrays, as `save_params_only` pickles them) and the port's
`state_dict`, in both directions.

  * Flax Dense `kernel [in, out]` <-> Linear-shaped `weight [out, in]`,
    `bias` as is. vae_song_tpu.nn.blocks.Dense nests an nn.Dense named
    Dense_0, so those leaves sit one level deeper than the MHA ones.
  * LayerNorm `scale` <-> `weight`, `bias` as is.
  * `decoder/query_embed` as is.

Each rule maps a port module path to its Flax path; the conversion
refuses leaves that no rule names, so a tree from a model the port does
not build (MoE, DeepSets) fails loudly instead of loading partly.
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
]
_LEAF = {"dense": {"weight": "kernel", "bias": "bias"},
         "norm": {"weight": "scale", "bias": "bias"}}


def flax_path(key: str) -> tuple[tuple[str, ...], bool]:
    """(Flax path, transpose?) of one port state_dict key."""
    if key == "decoder.query_embed":
        return ("decoder", "query_embed"), False
    module, _, leaf = key.rpartition(".")
    for pattern, template, kind in _RULES:
        m = re.fullmatch(pattern, module)
        if m and leaf in _LEAF[kind]:
            path = m.expand(template).split("/") + [_LEAF[kind][leaf]]
            return tuple(path), kind == "dense" and leaf == "weight"
    raise KeyError(f"no Flax counterpart for port parameter {key!r}")


def _flatten(tree, prefix=()):
    for name, sub in tree.items():
        if isinstance(sub, dict):
            yield from _flatten(sub, prefix + (name,))
        else:
            yield prefix + (name,), sub


def params_to_state_dict(params: dict, keys) -> dict[str, torch.Tensor]:
    """Flax params -> float32 tensors for the port keys `keys` (e.g.
    `model.state_dict().keys()`). Raises on a missing or unused leaf."""
    leaves = dict(_flatten(params))
    out, used = {}, set()
    for key in keys:
        path, transpose = flax_path(key)
        if path not in leaves:
            raise KeyError(f"Flax tree has no {'/'.join(path)} for {key!r}")
        arr = np.asarray(leaves[path], dtype=np.float32)
        out[key] = torch.tensor(arr.T if transpose else arr)
        used.add(path)
    unused = sorted("/".join(p) for p in leaves.keys() - used)
    if unused:
        raise KeyError(f"Flax leaves with no port counterpart: {unused[:8]}")
    return out


def state_dict_to_params(state_dict) -> dict:
    """Port state_dict -> nested Flax params of float32 numpy arrays."""
    params: dict = {}
    for key, t in state_dict.items():
        path, transpose = flax_path(key)
        arr = t.detach().float().cpu().numpy()
        node = params
        for name in path[:-1]:
            node = node.setdefault(name, {})
        node[path[-1]] = np.ascontiguousarray(arr.T if transpose else arr)
    return params


def load_flax_params(model: torch.nn.Module, params: dict) -> torch.nn.Module:
    """Copy a Flax parameter tree into `model` (on whatever device it is)."""
    model.load_state_dict(params_to_state_dict(params, model.state_dict().keys()))
    return model
