"""Parameter exports in the JAX trainer's format (port of
vae_song_tpu/train/checkpoint.py:save_params_only and load_params_only).

The JAX trainer writes `params/model_{epoch}.pkl` with
`save_params_only`: a plain pickle of {"params": nested dicts of numpy
arrays, "batch_stats": ...}. It reads and writes without jax or flax and
crosses into and out of the model through vae_song_tpu_torch.weights, so
weights move in both directions: a JAX export loads into the port, and
a port export loads into the JAX package. Unpickling runs code from the
file, so load only exports this project wrote.
"""

import os
import pickle

from vae_song_tpu_torch.weights import load_flax_params, state_dict_to_params


def save_params_only(path, model):
    """Write `model`'s parameters as the JAX package's `save_params_only`
    does: {"params": Flax tree of float32 numpy arrays, "batch_stats":
    {}} (the attention set models keep no BatchNorm statistics)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": state_dict_to_params(model.state_dict()), "batch_stats": {}}
    with open(path, "wb") as f:
        pickle.dump(payload, f)


def load_params_only(path, model):
    """Load the parameters of a `save_params_only` pickle into `model`
    and return it. BatchNorm statistics (the DeepSets models) are not
    ported yet, so an export that carries any raises."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if payload.get("batch_stats"):
        raise NotImplementedError(
            f"{path} carries BatchNorm statistics; the models that use them "
            "are not ported yet"
        )
    return load_flax_params(model, payload["params"])
