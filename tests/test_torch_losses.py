"""The loss terms of the port (ops/losses.py) against the JAX package's on
the same inputs: values and gradients, f32. The reductions are the
reference's own (mean over the batch or the Monte-Carlo samples, sum over
the rest), pairwise_reg's [L, L, D] broadcast included."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.ops import losses as jax_losses
from vae_song_tpu_torch.ops import losses

RNG = np.random.default_rng(0)
X = RNG.random((16, 28, 28, 1)).astype(np.float32)
RECON = (X + 0.1 * RNG.normal(size=X.shape)).astype(np.float32)
P = RNG.normal(size=(16, 2)).astype(np.float32)
P_RECON = (P + 0.3 * RNG.normal(size=P.shape)).astype(np.float32)
MU = RNG.normal(size=(16, 8)).astype(np.float32)
LOGVAR = (0.5 * RNG.normal(size=(16, 8))).astype(np.float32)
Z = {n: RNG.normal(size=(n, 16, 8)).astype(np.float32) for n in (1, 4)}
Z_RECON = {n: (Z[n] + 0.2 * RNG.normal(size=Z[n].shape)).astype(np.float32) for n in (1, 4)}

# (name, JAX function, port function, inputs): each term on the shapes its
# models give it
CASES = [
    ("mse images", jax_losses.mse_recon, losses.mse_recon, (X, RECON)),
    ("mse points", jax_losses.mse_recon, losses.mse_recon, (P, P_RECON)),
    ("log_mse images", jax_losses.log_mse_recon, losses.log_mse_recon, (X, RECON)),
    ("log_mse points", jax_losses.log_mse_recon, losses.log_mse_recon, (P, P_RECON)),
    ("recon_loss mse", lambda a, b: jax_losses.recon_loss(a, b, False),
     lambda a, b: losses.recon_loss(a, b, False), (X, RECON)),
    ("recon_loss log_mse", lambda a, b: jax_losses.recon_loss(a, b, True),
     lambda a, b: losses.recon_loss(a, b, True), (P, P_RECON)),
    ("kl", jax_losses.kl_divergence, losses.kl_divergence, (MU, LOGVAR)),
    ("kl_per_sample", jax_losses.kl_per_sample, losses.kl_per_sample, (MU, LOGVAR)),
    ("latent_recon L=4", jax_losses.latent_recon_loss, losses.latent_recon_loss,
     (Z[4], Z_RECON[4])),
    ("pairwise_reg L=1", lambda r, z: jax_losses.pairwise_reg(r, z),
     lambda r, z: losses.pairwise_reg(r, z), (np.float32(1.7), Z[1])),
    ("pairwise_reg L=4", lambda r, z: jax_losses.pairwise_reg(r, z),
     lambda r, z: losses.pairwise_reg(r, z), (np.float32(1.7), Z[4])),
]


# f32, the same elementwise math and reductions in other orders: measured
# up to 3.7e-7 of the largest value on the values and 7.0e-7 of the
# largest element on the gradients; bounds 1e-6 and 5e-6.
@pytest.mark.parametrize("name,jax_fn,port_fn,inputs", CASES, ids=[c[0] for c in CASES])
def test_loss_term_matches_jax(name, jax_fn, port_fn, inputs):
    want = np.asarray(jax_fn(*(jnp.asarray(a) for a in inputs)))
    args = [torch.tensor(a, requires_grad=True) for a in inputs]
    got = port_fn(*args)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-6 * float(np.abs(want).max()))
    # gradients of the summed term with respect to every input
    j_grads = jax.grad(lambda *a: jnp.sum(jax_fn(*a)), argnums=tuple(range(len(inputs))))(
        *(jnp.asarray(a) for a in inputs))
    p_grads = torch.autograd.grad(got.sum(), args)
    for g, w in zip(p_grads, j_grads):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=5e-6 * float(np.abs(w).max()))

