"""The FlexibleVAE family's train step under `mixed_precision: true`
(bf16 trunk) in the port against JAX `make_train_step` on the CPU
(jax_parity.flex_step_parity: the same weights, statistics, inputs and
noise; loss terms, gradient, moved share, running statistics), the MLP
models; the conv models have tests/test_torch_flexible_train_bf16_conv.py.

The JAX step runs eagerly here (jax.disable_jit): each op then rounds as
Flax declares it, as the port does. Jitted, XLA's CPU fusions keep some
bf16 intermediates in f32 (a Dense's product, its bias add and the
BatchNorm), and the jitted step lands about as far from the eager one as
bf16 lets the gradient move: a bf16 output one ulp apart changes a
BatchNorm'd channel, and the gradient with it.
"""

import pytest

from jax_parity import flex_step_parity

# (loss terms relative, gradient relative L2, moved share, statistics
# relative to max(1, max|stat|)), fixed: no looser than the set models'
# bf16 bounds (tests/test_torch_train.py CPU_BF16_BOUNDS: 5e-3 on the first
# step's loss terms, 0.2 on its gradient). Measured, port against JAX's
# eager step: mlp1d-res L = 4 1.7e-6, 1.3e-2, 2.8e-3, 1.2e-7; mlp2d 3.1e-7,
# 5.6e-3, 6.9e-4, 9.6e-8. The gradient bound is 5e-2 here; the conv models
# (tests/test_torch_flexible_train_bf16_conv.py) keep the set models' 0.2.
# For scale (printed on failure): the port's and JAX's bf16 gradients lie
# 0.72 and 9.8e-2 from a float64 run of the port: the two packages agree
# because they round at the same points, not because bf16 determines the
# gradient.
BF16_BOUNDS = (5e-3, 5e-2, 0.2, 5e-3)
# The port's pre-BatchNorm biases' gradient over the largest gradient
# element: the bias is added in bf16, so its gradient sums bf16 terms (in
# f32): measured up to 4.8e-3. JAX's eager step sums them in bf16
# (measured up to 0.93): not bounded.
PRE_BN_GRAD = 2e-2


def check_bf16(result, bounds=BF16_BOUNDS):
    diffs = result["diffs"]
    assert all(d <= b for d, b in zip(diffs, bounds)), (
        diffs, bounds, {k: result[k] for k in ("f64_gap", "jax_f64_gap")})
    assert result["pre_bn"][0] <= PRE_BN_GRAD, result["pre_bn"]


@pytest.mark.parametrize("kind,arch,n_samples", [
    ("lrvae", "mlp1d-res", 4),
    ("nae", "mlp2d", 1),
])
def test_bf16_train_step_matches_jax(monkeypatch, kind, arch, n_samples):
    check_bf16(flex_step_parity(monkeypatch, kind, arch, True, n_samples, eager=True))
