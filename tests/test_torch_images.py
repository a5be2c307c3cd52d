"""The port's image data (vae_song_tpu_torch/data/images.py) against the JAX
package: the stand-in images of all five datasets through `load_dataset`,
bitwise, with their augments; the augments' draws; and the augment
applied batch by batch through the pipeline. The augments on JAX's own
draws are in tests/test_torch_augment.py, the readers on files in
tests/test_torch_image_files.py."""

import numpy as np
import pytest
import torch

from vae_song_tpu import data as jax_data
from vae_song_tpu_torch import data
from vae_song_tpu_torch.data import images
from vae_song_tpu_torch.data.pipeline import iterate_batches
from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")

def _equal(got, want):
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name", sorted(images.IMAGE_SHAPES))
def test_fake_datasets_match_jax(name):
    """`fake_<name>` through both packages' load_dataset: the same 4096 +
    1024 stand-in images and labels, bit for bit, and the same augment."""
    got = data.load_dataset(f"fake_{name}", seed=3)
    want = jax_data.load_dataset(f"fake_{name}", seed=3)
    for g, w in zip(got[:2], want[:2]):
        assert g.X.shape == (len(g.X), *images.IMAGE_SHAPES[name])
        _equal((g.X, g.y), (w.X, w.y))
    assert (len(got[0]), len(got[1])) == (4096, 1024)
    kinds = {"mnist": images.MnistAugment, "cifar10": images.FlipAugment,
             "celeba": images.FlipAugment}
    assert (want[2] is None) == (got[2] is None)
    assert got[2] is None or isinstance(got[2], kinds[name])


def test_draws_come_from_the_generator():
    """The same generator state gives the same draws; the draws lie in
    their ranges; the flip mask is Bernoulli(1/2)."""
    aug = images.make_mnist_augment()
    a = aug.draw(torch.Generator().manual_seed(1), 4096)
    b = aug.draw(torch.Generator().manual_seed(1), 4096)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    lo = torch.tensor([-20.0, 0.9, np.log(0.9), 0.0, 0.0])
    hi = torch.tensor([20.0, 1.0, np.log(1.1), 1.0, 1.0])
    assert bool(((a >= lo - 1e-6) & (a <= hi + 1e-6)).all())
    mask = images.make_flip_augment().draw(torch.Generator().manual_seed(2), 4096)
    assert mask.dtype == torch.bool and 0.45 < float(mask.float().mean()) < 0.55


def test_pipeline_applies_the_augment_batch_by_batch():
    """iterate_batches with an augment gives the batches of the numpy path
    warped with the generator's draws in batch order."""
    train, _, aug = data.load_dataset("fake_mnist", seed=0)
    plain = [x for x, _ in iterate_batches(train, 512, rng=np.random.default_rng(3))]
    augmented = [x for x, _ in iterate_batches(train, 512, rng=np.random.default_rng(3),
                                               augment=aug,
                                               augment_rng=torch.Generator().manual_seed(9))]
    gen = torch.Generator().manual_seed(9)
    assert len(plain) == len(augmented) == 8
    for x, y in zip(plain, augmented):
        assert y.shape == x.shape and y.is_contiguous()
        torch.testing.assert_close(y, aug.apply(x, aug.draw(gen, x.shape[0])), rtol=0, atol=0)
