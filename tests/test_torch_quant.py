"""Int8 post-training quantisation for decoding in the port
(serving/quant.py, cli/generate.py --quant int8) against the JAX package's
(vae_song_tpu/serving/quant.py): the six cases of tests/test_quant.py,
each held to JAX's quantised output on the same weights and inputs. The
int8 operands and the int32 product are bitwise JAX's."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.serving import quant as jax_quant
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.cli import generate
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.serving import quant
from vae_song_tpu_torch.train import checkpoint

from jax_parity import one_thread  # noqa: F401 (a fixture)

# one torch thread a test: pytest-xdist runs six processes on the same cores
pytestmark = pytest.mark.usefixtures("one_thread")


def _jax_product(x, w8):
    """JAX's int8 operands and int32 product of int8_dense (its :104-110)."""
    xf = jnp.asarray(x, jnp.float32)
    s_x = jnp.maximum(jnp.max(jnp.abs(xf), axis=-1, keepdims=True) / 127.0, 1e-12)
    x8 = jnp.clip(jnp.round(xf / s_x), -127, 127).astype(jnp.int8)
    y32 = jax.lax.dot_general(x8, w8, (((x8.ndim - 1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    return np.asarray(x8), np.asarray(s_x), np.asarray(y32)


def _port_product(x, w8):
    x8, s_x = quant.quantize_activations(torch.from_numpy(x))
    return x8.numpy(), s_x.numpy(), quant.int8_matmul(x8, torch.from_numpy(w8)).numpy()


def _check_int8_dense(x, w, b):
    """The port's quantised kernel, activations, int32 product and output
    against JAX's on (x, w [K, F], b): everything but the output bitwise,
    the output to 1e-6 relative to its max. Returns the port's output."""
    j_w8, j_scale = jax_quant._quantize_kernel(jnp.asarray(w))
    w8, scale = quant._quantize_kernel(torch.from_numpy(w))
    np.testing.assert_array_equal(w8.numpy(), np.asarray(j_w8))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(j_scale))
    for got, want in zip(_port_product(x, w8.numpy()), _jax_product(x, j_w8)):
        np.testing.assert_array_equal(got, want)
    bias = None if b is None else jnp.asarray(b)
    want = np.asarray(jax_quant.int8_dense(jnp.asarray(x), j_w8, j_scale, bias))
    got = quant.int8_dense(torch.from_numpy(x), w8, scale,
                           None if b is None else torch.from_numpy(b)).numpy()
    assert float(np.abs(got - want).max()) <= 1e-6 * float(np.abs(want).max())
    return got


def test_int8_dense_exact_on_representable_values():
    """tests/test_quant.py's first case: weights and activations on exact
    int8 grids, so the quantised product is the float one (to 1e-6)."""
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, size=(32, 16)).astype(np.float32) * 0.25
    w[0, :] = 127 * 0.25
    x = rng.integers(-127, 128, size=(4, 32)).astype(np.float32) * 0.5
    x[:, 0] = 127 * 0.5
    b = rng.normal(size=(16,)).astype(np.float32)
    got = _check_int8_dense(x, w, b)
    np.testing.assert_allclose(got, x @ w + b, rtol=1e-6, atol=1e-5)


def test_int8_dense_relative_error_random():
    """The second case: random [8, 256] by [256, 128], no bias; the port's
    relative error against the float product under JAX's 0.02."""
    rng = np.random.default_rng(1)
    w = rng.normal(size=(256, 128)).astype(np.float32)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    got = _check_int8_dense(x, w, None)
    want = x @ w
    assert np.abs(got - want).max() / np.abs(want).max() < 0.02


def _pair(kind, dataset, mp, seed=0):
    """The port model (seeded weights) and the JAX model with the same
    variables."""
    port = build_model(kind, dataset, mp, beta=0.01, alpha=0.01,
                       generator=torch.Generator().manual_seed(seed))
    variables = weights.state_dict_to_variables(port.state_dict())
    return port, jax_build_model(kind, dataset, mp, beta=0.01, alpha=0.01), variables


def _decodes(port, jmodel, variables, z, min_fan_in=16):
    """(port int8, JAX int8, JAX float) decodes of z, and both tables."""
    params = jax.tree.map(jnp.asarray, variables["params"])
    bs = jax.tree.map(jnp.asarray, variables["batch_stats"])
    j_table = jax_quant.quantize_dense_params(params, min_fan_in)
    j_q = np.asarray(jax_quant.make_quantized_decode(jmodel, bs)(j_table, params, jnp.asarray(z)))
    j_f = np.asarray(jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(z),
                                  train=False, method="decode"))
    table = quant.quantize_dense_params(port, min_fan_in)
    p_q = quant.make_quantized_decode(port, table)(torch.from_numpy(z)).numpy()
    return p_q, j_q, j_f, table, j_table


MLP = {"encoder_type": "mlp", "decoder_type": "mlp", "hchans": [32, 32]}
SET = dict(latent_channel=16, num_points=128, d_model=64, num_heads=2, ff_dim=64,
           num_encoder_layers=1, num_decoder_layers=1, use_attention=True)


@pytest.mark.parametrize("kind,dataset,mp", [
    ("vae", "pinwheel", MLP),
    ("setvae", "shapenet", SET),
])
def test_quantized_decode_matches_jax(kind, dataset, mp):
    """The third and fourth cases (the MLP VAE on pinwheel, a small
    SetVAE): the same table entries (keys, int8 kernels, scales; so
    `quantized_coverage` gives JAX's numbers), the port's int8 decode
    against JAX's int8 decode to 1e-5 relative to its max (measured
    6.1e-8 and 2.7e-7), within JAX's 0.05 of the float decode (7.1e-3 and
    9.1e-3) and not equal to it (the int8 path ran)."""
    port, jmodel, variables = _pair(kind, dataset, mp)
    z = np.random.default_rng(1).normal(size=(16 if kind == "vae" else 4,
                                              port.latent_channel)).astype(np.float32)
    p_q, j_q, j_f, table, j_table = _decodes(port, jmodel, variables, z)
    assert table.keys() == j_table.keys() and table
    for k, e in table.items():
        np.testing.assert_array_equal(e["w8"].numpy(), np.asarray(j_table[k]["w8"]))
        np.testing.assert_array_equal(e["scale"].numpy(), np.asarray(j_table[k]["scale"]))
    assert quant.quantized_coverage(table, port) == jax_quant.quantized_coverage(
        j_table, variables["params"])
    rel = float(np.abs(p_q - j_q).max() / np.abs(j_q).max())
    assert rel <= 1e-5, rel
    assert np.abs(p_q - j_f).max() / max(np.abs(j_f).max(), 1e-6) < 0.05
    assert not np.array_equal(p_q, j_f)


def test_min_fan_in_skips_small_kernels():
    """The fifth case: the same keys as JAX's table at min_fan_in 0 and 16;
    the fan-in-2 input layer is skipped at 16."""
    port, _, variables = _pair("vae", "pinwheel", MLP)
    for min_fan_in in (0, 16):
        assert quant.quantize_dense_params(port, min_fan_in).keys() == \
            jax_quant.quantize_dense_params(variables["params"], min_fan_in).keys()
    assert len(quant.quantize_dense_params(port, 16)) < len(quant.quantize_dense_params(port, 0))


def test_generate_cli_quant_int8(tmp_path):
    """The sixth case: cli/generate.py --quant int8 end to end from a saved
    checkpoint; and `generate_samples(quant="int8")` on given noise equals
    JAX's int8 decode of it to 1e-5 relative."""
    config = {"experiment_type": "vae", "common_params": {"exp_data": "pinwheel"},
              "model_params": dict(MLP, beta_list=[0.01])}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(config))
    model = generate.create_model_from_config(config)
    ckpt = tmp_path / "params" / "model_4.pkl"
    checkpoint.save_params_only(str(ckpt), model)
    out = generate.main(["--config", str(cfg), "--param_dir", str(ckpt), "--n_samples", "8",
                         "--batch_size", "4", "--device", "cpu", "--quant", "int8"])
    assert os.listdir(out)

    z = np.random.default_rng(2).normal(size=(2, 4, model.latent_channel)).astype(np.float32)
    got = generate.generate_samples(model, 8, 4, z=z, quant="int8")
    jmodel = jax_build_model("vae", "pinwheel", MLP, beta=0.01)
    variables = weights.state_dict_to_variables(model.state_dict())
    params = jax.tree.map(jnp.asarray, variables["params"])
    decode = jax_quant.make_quantized_decode(jmodel, jax.tree.map(jnp.asarray,
                                                                  variables["batch_stats"]))
    table = jax_quant.quantize_dense_params(params)
    want = np.concatenate([np.asarray(decode(table, params, jnp.asarray(zb))) for zb in z])
    assert float(np.abs(got - want).max()) <= 1e-5 * float(np.abs(want).max())
