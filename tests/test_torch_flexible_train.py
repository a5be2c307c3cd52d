"""The FlexibleVAE family's train step in the port against JAX
`make_train_step` on the CPU, the MLP models in f32: from the same
weights and BatchNorm statistics (through vae_song_tpu_torch.weights), on
the same inputs and noise [L, B, latent], the staged gradient for LRVAE
(with and without `pwise_reg`) and the composite one for VanillaVAE and
NaiveAE, one and four Monte-Carlo samples; `make_accum_train_step` at two
microbatches for LRVAE; and the staged gradient's decomposition. The
conv models have tests/test_torch_flexible_train_conv.py, bf16
tests/test_torch_flexible_train_bf16.py. JAX's gradient comes out of its
jitted step through `jax_parity.grads_capture`.

Compared (jax_parity.flex_step_parity): the loss terms (and `raw_kl`),
the gradient (relative L2), the share of parameter elements Adam's first
update moves apart by more than lr/100, and the running statistics. The
Dense biases a BatchNorm follows have an analytically zero gradient:
both sides compute roundoff there, which Adam's first update turns into
+-lr, so they are held to roundoff size and left out of the rest. The
port's f32 gradient is also held to a float64 run of the port.
"""

import numpy as np
import pytest
import torch

from vae_song_tpu_torch.train import steps
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

from jax_parity import flex_inputs, flex_pair, flex_step_parity

# Bounds on (loss terms relative, gradient relative L2, moved share,
# statistics relative to max(1, max|stat|)): summation order; measured up
# to 4.3e-6, 3.7e-5, 2.7e-6, 6.9e-7 (both tests below).
F32_BOUNDS = (1e-5, 1e-4, 1e-3, 1e-5)
# The port's f32 gradient against its float64 copy: measured up to 1.6e-5
# (JAX's 2.4e-5).
PORT_F64_GRAD_RTOL = 1e-4
# The pre-BatchNorm biases' gradient, roundoff of a sum over the batch,
# over the largest gradient element: measured up to 4.0e-7 on either side.
PRE_BN_GRAD = 1e-4


def _check(result, bounds=F32_BOUNDS):
    diffs = result["diffs"]
    assert all(d <= b for d, b in zip(diffs, bounds)), (diffs, bounds)
    assert max(result["pre_bn"]) <= PRE_BN_GRAD, result["pre_bn"]
    assert result["f64_gap"] <= PORT_F64_GRAD_RTOL, result["f64_gap"]


@pytest.mark.parametrize("kind,arch,n_samples,extra", [
    ("lrvae", "mlp1d", 1, {}),
    ("lrvae", "mlp1d", 4, {"pwise_reg": True}),
    ("lrvae", "mlp1d", 1, {"pwise_reg": True}),
    ("vae", "mlp1d", 4, {}),
    ("nae", "mlp1d-res", 1, {}),
    ("lrvae", "mlp1d-res", 4, {}),
    ("lrvae", "mlp2d", 4, {}),
    ("vae", "mlp2d", 1, {}),
])
def test_train_step_matches_jax(monkeypatch, kind, arch, n_samples, extra):
    _check(flex_step_parity(monkeypatch, kind, arch, False, n_samples, extra))


# Two microbatches: JAX's scan hands every microbatch the same noise; the
# statistics move microbatch after microbatch and the latent-recon term
# carries JAX's 1/n_micro.
def test_accum_step_matches_jax(monkeypatch):
    _check(flex_step_parity(monkeypatch, "lrvae", "mlp1d", False, 4, n_micro=2))


def test_staged_gradient_scales_the_encoders_latent_recon_share():
    """Staged against composite on the same model and batch: the decoder's
    gradients agree (up to summation order); the encoder's differ by
    (1 - 1e-4) times its gradient of the latent-recon term, BatchNorm's
    scale and bias included. That term's encoder gradient is ~100x the
    rest here, so the check is on norms: f32 roundoff of the larger one
    (measured 4.4e-8 of the two norms' sum; bound 1e-6)."""
    _, _, _, port = flex_pair("lrvae", "mlp1d")
    x = torch.from_numpy(flex_inputs("mlp1d", 16, seed=11))
    eps = torch.from_numpy(np.random.default_rng(12).normal(size=(1, 16, 2)).astype(np.float32))
    state = {k: v.clone() for k, v in port.state_dict().items()}
    names = [k for k, _ in port.named_parameters()]

    def grads_of(mode):
        port.load_state_dict(state)
        make_train_step(port, make_optimizer(port.parameters(), lr=0.0), mode)(x, eps, 1.0)
        return {k: p.grad.clone() for k, p in port.named_parameters()}

    staged, composite = grads_of("staged"), grads_of("composite")
    port.load_state_dict(state)
    port.train()
    outs = port(x, eps)
    lr_term = port.loss(x, *outs, wu_alpha=1.0)[3]
    g_lr = dict(zip(names, torch.autograd.grad(lr_term, list(port.parameters()),
                                               allow_unused=True)))
    assert steps.ENCODER_LR_LAMBDA == 1e-4
    moved = 0
    for k in names:
        want, scale = composite[k], float(composite[k].norm())
        if k.startswith("encoder.") and g_lr[k] is not None:
            want = want - (1 - steps.ENCODER_LR_LAMBDA) * g_lr[k]
            scale += float(g_lr[k].norm())
            moved += int(g_lr[k].abs().max() > 0)
        assert float((staged[k] - want).norm()) <= 1e-6 * scale, k
    assert moved > 10          # encoder weights, biases, BatchNorm scales and biases
