"""The port's FID (vae_song_tpu_torch/ops/fid.py, ops/inception.py) against
the JAX package: the Frechet distance and fid_score on the same features,
the seeded random-conv features and the weights the port carries for
them, and InceptionV3 pool3 features with the synthetic state dict."""

import numpy as np
import pytest
import torch

from vae_song_tpu.data.images import fake_image_dataset
from vae_song_tpu.ops import fid as jax_fid
from vae_song_tpu.ops import inception as jax_inception
from vae_song_tpu_torch.ops import fid, inception
from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")

# The metric is the same numpy/scipy code on the same features.
FID_RTOL = 1e-6
# Random-conv features, the port's f32 convolutions against XLA's on the
# CPU: summation order only (measured 1.2e-7 at max|f| 0.77).
CONV_FEATURE_ATOL = 1e-5
# InceptionV3 pool3 through 94 convolutions and the 299 x 299 resize:
# summation order only (measured 3.8e-7 relative to max|f|).
INCEPTION_RTOL = 1e-4


def test_frechet_distance_and_fid_score_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(300, 24))
    b = rng.normal(size=(200, 24)) * 1.3 + 0.2
    mu1, s1 = fid.gaussian_stats(a)
    mu2, s2 = fid.gaussian_stats(b)
    want = jax_fid.frechet_distance(*jax_fid.gaussian_stats(a), *jax_fid.gaussian_stats(b))
    assert abs(fid.frechet_distance(mu1, s1, mu2, s2) - want) <= FID_RTOL * abs(want)
    assert abs(fid.fid_from_features(a, b) - want) <= FID_RTOL * abs(want)
    assert fid.fid_from_features(a, a) == pytest.approx(0.0, abs=1e-6)

    def features(batch):
        return np.asarray(batch, np.float64).reshape(len(batch), -1)[:, :12]

    real = [b for b in rng.random((4, 40, 4, 4, 1))]
    fake = [b for b in rng.random((3, 40, 4, 4, 1)) ** 2]
    want = jax_fid.fid_score(features, real, fake)
    assert abs(fid.fid_score(features, real, fake) - want) <= FID_RTOL * abs(want)


def test_committed_conv_weights_are_jax_draws():
    """fid_conv_seed0.npz holds what JAX draws now for seed 0, bit for bit
    (scripts/make_fid_conv_weights.py wrote it), and loads with numpy."""
    import importlib.util
    import os

    spec = importlib.util.spec_from_file_location("make_fid_conv_weights", os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts",
        "make_fid_conv_weights.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    for c in (1, 3):
        convs, proj = fid.load_conv_weights(c)
        want_convs, want_proj = script.draw(c)
        assert [w.shape for w in convs] == [(3, 3, c, 8), (3, 3, 8, 16), (3, 3, 16, 32)]
        for got, want in zip([*convs, proj], [*want_convs, want_proj]):
            assert got.dtype == want.dtype == np.float32
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["mnist", "cifar10", "celeba"])
def test_conv_features_match_jax(name):
    (x, _), (x2, _) = fake_image_dataset(name, 64, 32, seed=1)
    jax_extract = jax_fid.make_conv_feature_extractor(x.shape[1:])
    port = fid.make_conv_feature_extractor(x.shape[1:], device="cpu")
    want = np.asarray(jax_extract(x))
    got = fid.extract(port, x)
    assert got.shape == want.shape == (64, 64)
    assert float(np.abs(got - want).max()) <= CONV_FEATURE_ATOL
    # the score through each package's extractor
    want = jax_fid.fid_score(jax_extract, [x], [x2])
    assert abs(fid.fid_score(port, [x], [x2]) - want) <= 1e-4 * abs(want)


def test_other_seeds_raise():
    with pytest.raises(ValueError, match="seed 0"):
        fid.make_conv_feature_extractor((28, 28, 1), seed=1, device="cpu")
    with pytest.raises(ValueError, match="1 and 3 input channels"):
        fid.make_conv_feature_extractor((28, 28, 2), device="cpu")


def test_default_extractor_reads_the_weights_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("VST_FID_WEIGHTS", raising=False)
    extractor, is_inception = fid.default_extractor((28, 28, 1), device="cpu")
    assert isinstance(extractor, fid.RandomConvFeatures) and not is_inception
    monkeypatch.setenv("VST_FID_WEIGHTS", str(tmp_path / "missing.npz"))
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        fid.default_extractor((28, 28, 1), device="cpu")


def test_inception_matches_jax(tmp_path):
    """The synthetic state dict (bitwise the JAX fixture's), written as the
    .npz a user would give, on 2 MNIST-shaped images through both packages;
    and as a .pt through default_extractor."""
    sd = inception.synthetic_state_dict()
    want_sd = jax_inception.synthetic_state_dict()
    assert sd.keys() == want_sd.keys()
    for k in sd:
        np.testing.assert_array_equal(sd[k], want_sd[k])
    path = str(tmp_path / "inception.npz")
    np.savez(path, **sd)
    x = np.random.default_rng(0).random((2, 28, 28, 1), dtype=np.float32)
    want = np.asarray(jax_inception.InceptionV3Features(path)(x))
    got = fid.extract(inception.InceptionV3Features(path, device="cpu"), x)
    assert got.shape == want.shape == (2, 2048)
    assert float(np.abs(got - want).max()) <= INCEPTION_RTOL * float(np.abs(want).max())
    pt = str(tmp_path / "inception.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, pt)
    extractor, is_inception = fid.default_extractor((28, 28, 1), weights_path=pt, device="cpu")
    assert is_inception
    np.testing.assert_array_equal(fid.extract(extractor, x), got)
