"""Read the JAX trainer's parameter exports (port of
vae_song_tpu/train/checkpoint.py:load_params_only).

The JAX trainer writes `params/model_{epoch}.pkl` with
`save_params_only`: a plain pickle of {"params": nested dicts of numpy
arrays, "batch_stats": ...}. It reads without jax or flax and goes into
the model through vae_song_tpu_torch.weights. Unpickling runs code from
the file, so load only exports this project wrote.
"""

import pickle

from vae_song_tpu_torch.weights import load_flax_params


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
