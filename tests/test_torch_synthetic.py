"""The synthetic 2-D datasets in the port (a copy of the JAX package's
numpy generators) against the JAX package: the same `default_rng` draws
give bitwise equal arrays, generator by generator and through
`load_dataset`'s dispatch; `seed=None` stays non-deterministic; the image
datasets without their files raise naming where they looked."""

import re

import numpy as np
import pytest

from vae_song_tpu import data as jax_data
from vae_song_tpu.data import synthetic as jax_synthetic
from vae_song_tpu_torch import data
from vae_song_tpu_torch.data import synthetic

GENERATORS = [
    ("generate_spin_data", dict(num_data=1000, num_classes=5), True),
    ("generate_spin_data", dict(num_data=999, num_classes=3, spiral=0.9), True),
    ("generate_pinwheel_data_legacy", dict(radial_std=0.3, tangential_std=0.05, num_classes=5,
                                           num_per_class=50, rate=0.25), True),
    ("generate_chessboard_data", dict(n_data=777, chessboard_size=4), True),
    ("generate_grid_mixture", dict(K=4, N0=30, std=0.05, L=2.0), True),
    ("generate_weighted_grid_mixture", dict(K=4, total_samples=503, pattern="corner_heavy"), False),
    ("generate_weighted_grid_mixture", dict(K=5, total_samples=400, pattern="center_heavy"), False),
    ("generate_weighted_grid_mixture", dict(K=3, total_samples=301, pattern="sparse_random"),
     False),
    ("generate_weighted_grid_mixture", dict(K=2, total_samples=100, weights=[1, 2, 3, 4]), False),
    ("generate_random_gaussian_mixture", dict(num_components=5, total_samples=333), False),
    ("generate_simple_gaussian_mixture", dict(num_components=6, total_samples=500,
                                              pattern="corner_heavy"), False),
    ("generate_simple_gaussian_mixture", dict(num_components=3, total_samples=90, stds=0.3,
                                              centers=[[0, 0], [1, 1], [2, 0]]), False),
]


def _equal(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _equal(g, w)
    else:
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,kwargs,takes_rng", GENERATORS)
def test_generators_are_bitwise_equal(name, kwargs, takes_rng):
    seed = {"rng": np.random.default_rng(5)} if takes_rng else {"seed": 5}
    seed_jax = {"rng": np.random.default_rng(5)} if takes_rng else {"seed": 5}
    _equal(getattr(synthetic, name)(**kwargs, **seed), getattr(jax_synthetic, name)(**kwargs,
                                                                                    **seed_jax))


@pytest.mark.parametrize("pattern", ["uniform", "corner_heavy", "center_heavy"])
def test_weights_from_pattern_match(pattern):
    for n, k in ((16, 4), (7, None)):
        assert synthetic.generate_weights_from_pattern(pattern, n, K=k) == \
            jax_synthetic.generate_weights_from_pattern(pattern, n, K=k)


@pytest.mark.parametrize("name,kwargs", [
    ("pinwheel", {}),
    ("chessboard", {}),
    ("grid_mixture", {"K": 4, "train_total": 800}),
    ("grid_mixture", {"K": 4, "train_total": 800, "distribution_pattern": "corner_heavy",
                      "test_N0": 7}),
    ("simple_gaussian_mixture", {"num_components": 5, "rgm_total": 600, "rgm_std": 0.2,
                                 "rgm_L": 3.0}),
])
def test_load_dataset_matches_jax(name, kwargs):
    train, test, aug = data.load_dataset(name, seed=11, **kwargs)
    j_train, j_test, j_aug = jax_data.load_dataset(name, seed=11, **kwargs)
    assert aug is None and j_aug is None
    for got, want in ((train, j_train), (test, j_test)):
        _equal((got.X, got.y), (want.X, want.y))


def test_unseeded_draws_differ():
    a, _, _ = data.load_dataset("pinwheel")
    b, _, _ = data.load_dataset("pinwheel")
    assert a.X.shape == (10000, 2) and not np.array_equal(a.X, b.X)


@pytest.mark.parametrize("name", data.IMAGE_DATASETS)
def test_image_datasets_name_their_roadmap_item(name, tmp_path, monkeypatch):
    """The image datasets are ported (tests/test_torch_images.py); without
    their files under the data root each one raises FileNotFoundError
    naming where it looked, as in JAX."""
    from vae_song_tpu_torch.data import images

    monkeypatch.setattr(images, "DATA_ROOT", str(tmp_path))
    with pytest.raises(FileNotFoundError, match=re.escape(str(tmp_path))):
        data.load_dataset(name)
