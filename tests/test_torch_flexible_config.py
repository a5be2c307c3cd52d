"""The pinwheel config's LR-VAE train step at the config's own width
(configs/config_pinwheel.yaml: twelve blocks of 16, B = 1024, L = 1, the
first sweep point), f32 against a float64 run of the port, in the port
and in JAX (`make_train_step`, jitted, the same weights and noise).

The gradient is piecewise smooth: each LeakyReLU input picks one of two
slopes. At this state a few inputs of the second encoder pass lie within
f32 roundoff of zero, so the port's f32 step and its float64 step compute
on different pieces, and there the decoder's gradient differs by about
half its norm. Computed on the f32 run's pieces (every LeakyReLU's slope
taken from that run), float64 lands within f32 roundoff of it; g_main
(recon + reg: the gradient of the same model with alpha = 0) does not
pass through the second encoder pass and needs no such help, in the port
or in JAX. chip_smoke.py phase 9 holds the card to the CPU the same way.
"""

import contextlib
import copy
import os

import jax
import numpy as np
import optax
import torch

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.steps import make_train_step as jax_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.cli.main import load_config
from vae_song_tpu_torch.data import load_dataset
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

from jax_parity import grad_gap, grads_capture, patch_eps, to_np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# f32 against float64, relative L2 over every leaf but the pre-BatchNorm
# biases: the full gradient on the f32 run's pieces (measured 1.7e-4; on
# float64's own pieces 0.37, 14 of 794624 LeakyReLU inputs on the other
# side of zero); g_main, measured port 1.4e-4, JAX 1.4e-3.
F32_RTOL = 1e-3
JAX_F32_RTOL = 1e-2


@contextlib.contextmanager
def _lrelu_pieces(monkeypatch, signs, force=False):
    """Every LeakyReLU within appends its input's sign pattern to `signs`;
    with `force` it takes its slopes from the next pattern of `signs`."""
    leaky, patterns = torch.nn.functional.leaky_relu, iter(signs)

    def piecewise(x, slope=0.01, inplace=False):
        if force:
            return torch.where(next(patterns), x, x * slope)
        signs.append(x > 0)
        return leaky(x, slope)

    with monkeypatch.context() as patch:
        patch.setattr(torch.nn.functional, "leaky_relu", piecewise)
        yield


def _port_grads(model, x, eps, dtype):
    model = copy.deepcopy(model).to(dtype)
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = dtype
    make_train_step(model, make_optimizer(model.parameters(), lr=1e-2))(
        torch.from_numpy(x).to(dtype), torch.from_numpy(eps).to(dtype), 0.5)
    return {k: p.grad.double() for k, p in model.named_parameters()}


def test_pinwheel_config_step_against_float64(monkeypatch):
    config = load_config(os.path.join(ROOT, "configs", "config_pinwheel.yaml"))
    mp = config["model_params"]
    batch = config["common_params"]["batch_size"]
    beta, alpha = mp["beta_list"][0], mp["alpha_list"][0]
    x = load_dataset("pinwheel", seed=8)[0].X[:batch].astype(np.float32)
    port = build_model("lrvae", "pinwheel", mp, beta=beta, alpha=alpha,
                       generator=torch.Generator().manual_seed(0))
    main = copy.deepcopy(port)
    main.alpha = 0.0
    eps = np.random.default_rng(9).standard_normal(
        (mp["num_mc_samples"], batch, port.latent_channel)).astype(np.float32)
    keys = [k for k, _ in port.named_parameters()]
    live = [k for k in keys if k not in pre_batchnorm_biases(keys)]
    decoder = [k for k in live if k.startswith("decoder.")]

    signs, signs64 = [], []
    with _lrelu_pieces(monkeypatch, signs):
        full32 = _port_grads(port, x, eps, torch.float32)
    with _lrelu_pieces(monkeypatch, signs, force=True):
        on_pieces = _port_grads(port, x, eps, torch.float64)
    with _lrelu_pieces(monkeypatch, signs64):
        full64 = _port_grads(port, x, eps, torch.float64)
    main64 = _port_grads(main, x, eps, torch.float64)
    main32 = _port_grads(main, x, eps, torch.float32)

    patch_eps(monkeypatch, eps)
    variables = weights.state_dict_to_variables(port.state_dict())
    jmodel = jax_build_model("lrvae", "pinwheel", mp, beta=beta, alpha=0.0)
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=1e-2))
    state = jax_state.TrainState.create(variables["params"], variables["batch_stats"], tx)
    state, _ = jax_train_step(jmodel, tx, L=mp["num_mc_samples"])(
        state, jax.numpy.asarray(x), 0.5, jax.random.PRNGKey(0))
    jax_main = {k: v.double() for k, v in
                weights.params_to_state_dict(to_np(state.opt_state[0]), keys).items()}

    readings = {"on the f32 pieces": grad_gap(full32, on_pieces, live),
                "g_main port": grad_gap(main32, main64, live),
                "g_main JAX": grad_gap(jax_main, main64, live),
                "own pieces": grad_gap(full32, full64, live),
                "own pieces, decoder": grad_gap(full32, full64, decoder),
                "flips": sum(int((a != b).sum()) for a, b in zip(signs, signs64))}
    assert readings["on the f32 pieces"] <= F32_RTOL, readings
    assert readings["g_main port"] <= F32_RTOL, readings
    assert readings["g_main JAX"] <= JAX_F32_RTOL, readings
