"""Helpers shared by the tests that hold the PyTorch port to the JAX
package on the CPU (tests/test_torch_*.py). Not a test module."""

import jax
import jax.numpy as jnp
import numpy as np
import optax


def to_np(tree):
    """A JAX tree as writable float32 numpy arrays."""
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def grads_capture():
    """A gradient transformation that passes its input through and keeps
    it as its state: chained before the optimizer, the jitted JAX train
    step hands back the gradient it computed in `opt_state[0]`."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def patch_eps(monkeypatch, eps):
    """jax.random.normal returns `eps` for draws of its shape (the
    reparameterisation noise), so JAX uses the noise the port is given.
    A jitted step keeps the eps it was traced with."""
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))
