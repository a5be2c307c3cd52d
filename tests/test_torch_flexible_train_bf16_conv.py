"""The FlexibleVAE family's conv models' train step under
`mixed_precision: true` (bf16 trunk) in the port against JAX
`make_train_step` on the CPU (jax_parity.flex_step_parity: the same
weights, statistics, inputs and noise; loss terms, gradient, moved
share, running statistics); the MLP models have
tests/test_torch_flexible_train_bf16.py.

The JAX step runs eagerly here (jax.disable_jit): each op then rounds as
Flax declares it, as the port does. Jitted, XLA's CPU fusions keep some
bf16 intermediates in f32 (a Dense's product, its bias add and the
BatchNorm), and the jitted step lands about as far from the eager one as
bf16 lets the gradient move: a bf16 output one ulp apart changes a
BatchNorm'd channel, and the gradient with it.
"""

import pytest

from jax_parity import flex_step_parity
from test_torch_flexible_train_bf16 import BF16_BOUNDS, check_bf16

# The set models' bf16 bounds (tests/test_torch_train.py CPU_BF16_BOUNDS:
# 0.2 on the first step's gradient); loss terms, moved share and
# statistics as the MLP models'. Measured, port against JAX's eager step:
# VanillaVAE conv/mlp L = 4 2.3e-3, 7.9e-2, 1.6e-2, 1.4e-3 (both packages
# 0.12 from a float64 run of the port); the staged LR-VAE conv/conv L = 1
# at the MNIST config's alpha 0.1 4.5e-3, 1.0e-1, 8.6e-2, 2.1e-3 (0.12 and
# 0.13). At alpha 0.5 the staged LR-VAE's latent-recon term, which passes
# through the second encoder pass, dominates its gradient, and bf16 no
# longer determines it: at conv/mlp, B = 16 and 32, L = 1 and 4, the
# port's and JAX's bf16 gradients lie 0.50-0.54 from the float64 run. Its
# f32 step is held to JAX at alpha 0.5 in
# tests/test_torch_flexible_train_conv.py.
BF16_CONV_BOUNDS = (BF16_BOUNDS[0], 0.2, *BF16_BOUNDS[2:])


@pytest.mark.parametrize("kind,arch,n_samples,alpha", [
    ("vae", "conv-mlp", 4, 0.5),
    ("lrvae", "conv-conv", 1, 0.1),
])
def test_bf16_conv_train_step_matches_jax(monkeypatch, kind, arch, n_samples, alpha):
    check_bf16(flex_step_parity(monkeypatch, kind, arch, True, n_samples, eager=True,
                                alpha=alpha), BF16_CONV_BOUNDS)
