"""The port's image augments (vae_song_tpu_torch/data/images.py) on JAX's
own draws: the MNIST rotation-and-crop matrices from the uniforms JAX
draws, the bilinear warp on the matrices JAX builds against JAX's
`make_mnist_augment`, and the flip on JAX's Bernoulli mask."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.data import images as jax_images
from vae_song_tpu_torch.data import images
from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")

# The matrix builder against JAX's, relative to max(1, |entry|). XLA's and
# torch's f32 cos, sin and exp differ by one ulp, and the translation
# column (|m| up to 27) carries that as one ulp of its own (1.9e-6 at
# |m| >= 16). Measured: 2.9e-6 absolute, 1.1e-7 relative.
MATRIX_RTOL = 1e-6
# The warp on JAX's matrices against JAX's warp: grid_sample receives the
# source coordinates normalised by (W - 1) / 2 and un-normalises them,
# which moves them by an ulp or two of |coordinate| <= 28 (3.8e-6), and a
# pixel's value moves by at most that times the image's largest
# neighbour difference. Measured: 5.5e-6.
WARP_ATOL = 1e-5



def _jax_draws(key, b, degrees=20.0, scale=(0.9, 1.0), ratio=(0.9, 1.1)):
    """The five uniforms JAX `_rotation_crop_matrix` draws for each of the b
    keys `make_mnist_augment` splits from `key`."""
    def one(k):
        k1, k2, k3, k4, k5 = jax.random.split(k, 5)
        return jnp.stack([
            jax.random.uniform(k1, (), minval=-degrees, maxval=degrees),
            jax.random.uniform(k2, (), minval=scale[0], maxval=scale[1]),
            jax.random.uniform(k3, (), minval=jnp.log(ratio[0]), maxval=jnp.log(ratio[1])),
            jax.random.uniform(k4, (), minval=0.0, maxval=1.0),
            jax.random.uniform(k5, (), minval=0.0, maxval=1.0),
        ])

    return np.array(jax.vmap(one)(jax.random.split(key, b)), np.float32)


def _jax_matrices(key, b, h, w):
    return np.array(jax.vmap(lambda k: jax_images._rotation_crop_matrix(
        k, h, w, 20.0, (0.9, 1.0), (0.9, 1.1)))(jax.random.split(key, b)))


def test_rotation_crop_matrices_match_jax():
    key = jax.random.PRNGKey(11)
    got = images.rotation_crop_matrices(torch.from_numpy(_jax_draws(key, 64)), 28, 28).numpy()
    want = _jax_matrices(key, 64, 28, 28)
    assert got.shape == want.shape == (64, 2, 3) and got.dtype == np.float32
    gap = np.abs(got - want) / np.maximum(1.0, np.abs(want))
    assert gap.max() <= MATRIX_RTOL, gap.max()


def test_mnist_warp_matches_jax_augment():
    """The warp on the matrices JAX builds for the keys make_mnist_augment
    splits, against make_mnist_augment()(key, batch); and the whole port
    augment on JAX's draws, within the same bound."""
    (x, _), _ = jax_images.fake_image_dataset("mnist", 48, 1, seed=2)
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax_images.make_mnist_augment()(key, x))
    got = images.affine_warp(torch.from_numpy(x.copy()),
                             torch.from_numpy(_jax_matrices(key, 48, 28, 28))).numpy()
    assert got.shape == want.shape and float(np.abs(got - want).max()) <= WARP_ATOL
    got = images.make_mnist_augment().apply(torch.from_numpy(x.copy()),
                                            torch.from_numpy(_jax_draws(key, 48))).numpy()
    assert float(np.abs(got - want).max()) <= WARP_ATOL
    assert float(np.abs(got - x).max()) > 0.1          # the images did move


def test_flip_matches_jax_bitwise():
    (x, _), _ = jax_images.fake_image_dataset("cifar10", 32, 1, seed=4)
    key = jax.random.PRNGKey(5)
    mask = np.array(jax.random.bernoulli(key, 0.5, (32,)))
    want = np.asarray(jax_images.make_flip_augment()(key, x))
    got = images.flip(torch.from_numpy(x.copy()), torch.from_numpy(mask)).numpy()
    assert 0 < mask.sum() < 32
    np.testing.assert_array_equal(got, want)
