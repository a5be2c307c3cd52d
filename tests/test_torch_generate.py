"""cli/generate.py of the port for every family, on checkpoints the JAX
package writes: an image model (the MNIST config's LR-VAE, narrowed) and a
1-D model (the pinwheel config's, narrowed). The CLI writes JAX's files,
and the decodes from the carried weights match JAX's `generate_samples`
on the same z within 1e-5."""

import os

import jax
import numpy as np
import pytest
import yaml

from vae_song_tpu.cli import generate as jax_generate
from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train.loop import init_model
from vae_song_tpu.train.state import TrainState, make_optimizer
from vae_song_tpu_torch.cli import generate
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")

# f32 decodes of the same weights on the same z: summation order only
# (measured 1.3e-7 on the images, 2.2e-8 on the 1-D points).
DECODE_ATOL = 1e-5

CONFIGS = {
    "mnist": {"experiment_type": "lrvae",
              "common_params": {"exp_data": "mnist", "batch_size": 8},
              "model_params": {"beta_list": [0.001], "alpha_list": [0.1], "encoder_type": "mlp",
                               "decoder_type": "mlp", "hchans": [16, 16]}},
    "pinwheel": {"experiment_type": "lrvae",
                 "common_params": {"exp_data": "pinwheel", "batch_size": 8},
                 "model_params": {"beta_list": [0.01], "alpha_list": [0.1],
                                  "encoder_type": "mlp", "decoder_type": "mlp",
                                  "hchans": [16, 16, 16]}},
}


def _jax_checkpoint(tmp_path, name):
    """The JAX model of CONFIGS[name] with its seed-0 initial parameters,
    written as the JAX trainer writes params/model_{epoch}.pkl."""
    config = CONFIGS[name]
    path = tmp_path / f"{name}.yaml"
    path.write_text(yaml.safe_dump(config))
    jmodel = jax_generate.create_model_from_config(config)
    params, bs = init_model(jmodel, jax_generate._sample_input_for(jmodel), seed=0)
    pkl = tmp_path / "params" / "model_0.pkl"
    pkl.parent.mkdir()
    jax_ckpt.save_params_only(str(pkl), params, bs)
    return str(path), str(pkl), jmodel, TrainState.create(params, bs, make_optimizer(lr=0.0))


@pytest.mark.parametrize("name,files", [
    ("mnist", ["samples_0000.png", "samples_0001.png"]), ("pinwheel", ["samples_hist.png"])])
def test_generate_matches_jax(tmp_path, name, files):
    config, pkl, jmodel, state = _jax_checkpoint(tmp_path, name)
    out = generate.main(["--config", config, "--param_dir", pkl, "--n_samples", "20",
                         "--batch_size", "8", "--device", "cpu"])
    assert out == os.path.join(os.path.dirname(pkl), "gen_samples")
    assert sorted(os.listdir(out)) == files

    n, batch, seed = 20, 8, 3
    want = jax_generate.generate_samples(jmodel, state, n, batch, seed)
    key = jax.random.PRNGKey(seed)
    z = np.stack([np.asarray(jax.random.normal(jax.random.fold_in(key, i),
                                               (batch, jmodel.latent_channel)))
                  for i in range(0, n, batch)])
    port = generate.create_model_from_config(CONFIGS[name])
    ckpt_lib.load_params_only(pkl, port)
    got = generate.generate_samples(port, n, batch, z=z)
    assert got.shape == want.shape == ((n, 28, 28, 1) if name == "mnist" else (n, 2))
    assert float(np.abs(got - np.asarray(want)).max()) <= DECODE_ATOL
