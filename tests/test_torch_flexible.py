"""The FlexibleVAE family (NaiveAE, VanillaVAE, LRVAE with MLP and conv
encoders and decoders) in the port against the JAX package on the CPU,
with the same weights (through vae_song_tpu_torch.weights), the same
BatchNorm statistics, inputs and noise: the per-dataset defaults, the
forward passes (L Monte-Carlo samples, the latent-reconstruction pass,
the legacy z-source forwards), the loss terms and the BatchNorm
statistics a train-mode forward moves. The blocks and the weight map
have tests/test_torch_flexible_blocks.py, the train step
tests/test_torch_flexible_train*.py.

JAX runs eagerly here (no jit): every op then rounds as Flax declares
it, which is what the port copies. Under jit XLA's CPU fusions keep
some bf16 intermediates in f32 (a Dense's product and its bias add,
then the BatchNorm); the jitted train steps are held to the port in
tests/test_torch_flexible_train*.py. Every bound sits beside the
difference it was set from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.models import flexible as jax_flexible
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models import flexible
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn import blocks

from jax_parity import FLEX_ARCHS, flex_inputs, flex_pair, max_rel, patch_eps, rel_err

B = 16
OUT_NAMES = ("recon", "mu", "logvar", "z", "z_recon")


# ---------------------------------------------------------------- helpers of the JAX side


def test_dataset_defaults_and_padding_schedule_match_jax():
    assert flexible.DATASET_DEFAULTS == jax_flexible.DATASET_DEFAULTS
    for ds in flexible.DATASET_DEFAULTS:
        assert flexible.resolve_dataset_defaults(ds, [4, 4]) == \
            jax_flexible.resolve_dataset_defaults(ds, [4, 4])
    with pytest.raises(ValueError):
        flexible.resolve_dataset_defaults("shapenet")
    for dim in range(1, 70):
        for depth in range(1, 5):
            assert flexible.transpose_padding_schedule(dim, depth) == \
                jax_flexible.transpose_padding_schedule(dim, depth)
    assert flexible.transpose_padding_schedule(28, 3) == (4, [0, 1, 1])


# ---------------------------------------------------------------- the models' forward


def _jax_forward(jmodel, params, bs, x, n_samples, train, method=None, **kw):
    """Eager apply (Flax's declared roundings) with the sampling noise
    patched in by the caller."""
    return jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), train=train,
                        rngs={"sampling": jax.random.PRNGKey(0)}, mutable=["batch_stats"],
                        method=method, **kw)


# (kind, arch, mixed, L): every family, every encoder/decoder pair, f32
# and bf16, one and four Monte-Carlo samples, residual variants.
FORWARD_CASES = [
    ("lrvae", "mlp1d", False, 4), ("lrvae", "mlp1d", True, 4),
    ("vae", "mlp1d-res", False, 4), ("nae", "mlp1d-res", True, 1),
    ("vae", "mlp2d", False, 1), ("lrvae", "mlp2d", True, 4),
    ("vae", "conv-mlp", False, 4), ("lrvae", "conv-mlp", True, 1),
    ("nae", "conv-conv", False, 4), ("vae", "conv-conv", True, 4), ("lrvae", "conv-conv", False, 1),
]

# Bounds on (outputs, loss terms, running statistics), each relative:
# outputs and statistics to max(1, max|want|), loss terms to |want|.
# Train mode (the statistics of this batch) and eval mode (the running
# ones). f32: summation order; the largest is z_recon, two BatchNorm'd
# passes deep: measured 1.9e-4 (conv-conv), 5.5e-6 on the loss terms,
# 7.5e-6 on the statistics.
F32_BOUNDS = (5e-4, 1e-5, 1e-5)
# bf16, MLP models: Flax's roundings, but a long bf16 product (mlp2d's
# 392- and 784-wide layers) summed in another order in f32 can round one
# ulp (2^-8) the other way, which the next BatchNorm carries on: measured
# 2.5e-3 (z_recon), 1.1e-5 on the loss terms, 1.4e-5 on the statistics.
BF16_MLP_BOUNDS = (1e-2, 1e-4, 1e-4)
# bf16, conv models: the one-ulp flips of test_blocks_match_flax in every
# conv block, carried through both passes and renormalised by every
# BatchNorm: measured 0.10 (z_recon), 2.2e-2 on the others, 3.8e-3 on the
# loss terms (the set models' first-step bf16 bound, 5e-3,
# tests/test_torch_train.py, holds), 2.0e-3 on the statistics.
BF16_CONV_BOUNDS = (0.25, 5e-3, 5e-3)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("kind,arch,mixed,n_samples", FORWARD_CASES)
def test_forward_and_loss_match_jax(monkeypatch, kind, arch, mixed, n_samples, train):
    jmodel, params, bs, port = flex_pair(kind, arch, mixed)
    x = flex_inputs(arch, B, seed=3)
    eps = np.random.default_rng(4).normal(size=(n_samples, B, port.latent_channel)).astype(
        np.float32)
    patch_eps(monkeypatch, eps)
    outs, new = _jax_forward(jmodel, params, bs, x, n_samples, train, L=n_samples)
    want_terms = jmodel.loss(jnp.asarray(x), *outs, wu_alpha=0.3)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(eps))
        got_terms = port.loss(torch.from_numpy(x), *got, wu_alpha=0.3)
    out_tol, loss_tol, stat_tol = (F32_BOUNDS if not mixed else
                                   BF16_CONV_BOUNDS if "conv" in arch else BF16_MLP_BOUNDS)
    for name, g, w in zip(OUT_NAMES, got, outs):
        assert g.dtype == torch.float32, name
        assert rel_err(g, w) <= out_tol, (name, rel_err(g, w))
    assert got[3].shape == (n_samples, B, port.latent_channel)
    for g, w in zip(got_terms, want_terms):
        w = float(w)
        assert abs(float(g) - w) <= loss_tol * max(abs(w), 1e-6), (float(g), w)
    got_bs = weights.state_dict_to_variables(port.state_dict())["batch_stats"]
    assert max_rel(got_bs, new["batch_stats"]) <= stat_tol
    if not train:
        assert max_rel(got_bs, bs) == 0.0


def test_mixed_precision_keeps_heads_and_reconstruction_f32():
    """bf16 trunk, f32 (mu, logvar) head and reconstruction layer, as JAX."""
    for arch in ("mlp1d", "mlp2d", "conv-conv"):
        dataset, mp = FLEX_ARCHS[arch]
        port = build_model("lrvae", dataset, dict(mp, mixed_precision=True),
                           generator=torch.Generator().manual_seed(0))
        x = torch.from_numpy(flex_inputs(arch, 4))
        with torch.no_grad():
            outs = port.train()(x, torch.randn(2, 4, port.latent_channel))
        assert all(o.dtype == torch.float32 for o in outs), arch
        dtypes = {m.dtype for m in port.modules() if isinstance(m, (blocks.Dense, blocks.Conv))}
        assert dtypes == {torch.bfloat16, torch.float32}, arch


def test_batchnorm_statistics_move_four_times_a_train_forward():
    """encode(x), decode(z), decode(z.detach()), encode(recon_lr): the
    encoder's and the decoder's first running means each move twice."""
    _, _, _, port = flex_pair("lrvae", "mlp1d")
    x = torch.from_numpy(flex_inputs("mlp1d", B))
    calls = []
    for m in (port.encoder.mlp[0].norm, port.decoder.mlp[0].norm):
        m.register_forward_hook(lambda mod, args, out: calls.append(mod))
    with torch.no_grad():
        port.train()(x, torch.randn(1, B, port.latent_channel))
    assert calls == [port.encoder.mlp[0].norm, port.decoder.mlp[0].norm,
                     port.decoder.mlp[0].norm, port.encoder.mlp[0].norm]


# Eval mode, f32: measured up to 1.7e-7; bound 1e-5.
@pytest.mark.parametrize("z_source", ["Ex", "qzx", "pz"])
@pytest.mark.parametrize("kind", ["lrvae", "nae"])
def test_legacy_forwards_match_jax(monkeypatch, kind, z_source):
    jmodel, params, bs, port = flex_pair(kind, "mlp1d", extra={"z_source": z_source}
                                         if kind == "lrvae" else None)
    x = flex_inputs("mlp1d", B, seed=5)
    rng = np.random.default_rng(6)
    eps, prior = (rng.normal(size=(B, port.latent_channel)).astype(np.float32) for _ in range(2))
    draws = iter([eps, prior])
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(next(draws), dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))
    outs, _ = _jax_forward(jmodel, params, bs, x, 1, False, method="forward_legacy")
    port.eval()
    with torch.no_grad():
        got = port.forward_legacy(torch.from_numpy(x), torch.from_numpy(eps),
                                  torch.from_numpy(prior))
    for name, g, w in zip(OUT_NAMES, got, outs):
        if isinstance(w, float):
            assert g == w, name
        else:
            assert rel_err(g, w) <= 1e-5, name


