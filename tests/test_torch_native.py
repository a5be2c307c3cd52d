"""The port's native host library (vae_song_tpu_torch/data/native.py, its own
build of native/vsthost.cpp) against the JAX package's bindings on the same
source: permutations, gathers, resampled clouds, the loader's batches and
the CPU Chamfer distance bit for bit, with the library and through the
numpy fallbacks; the pipeline's native prefetch; and ShapeNet's
`materialize` on clouds of other sizes than num_points (the repaired
resampling)."""

import os

import numpy as np
import pytest

from vae_song_tpu.data import native as jax_native
from vae_song_tpu.data import pipeline as jax_pipeline
from vae_song_tpu.data import shapenet as jax_shapenet
from vae_song_tpu_torch.data import native, shapenet
from vae_song_tpu_torch.data.pipeline import ArrayDataset, iterate_batches


def test_the_port_builds_its_own_library():
    """Built from native/vsthost.cpp into build/native/, never the
    committed native/libvsthost.so."""
    assert native.available() and jax_native.available()
    path = native.library_path()
    assert path.exists() and path.parent.name == "native" and path.parent.parent.name == "build"
    assert os.path.realpath(native._load()._name) == os.path.realpath(path)
    assert os.path.realpath(path) != os.path.realpath(jax_native._LIB_PATH)


def _clouds(rng):
    return [rng.normal(size=(n, 3)).astype(np.float32) for n in (17, 64, 100, 64, 250, 3)]


@pytest.fixture(params=["library", "numpy fallback"])
def backend(request, monkeypatch):
    if request.param == "numpy fallback":
        monkeypatch.setattr(native, "_load", lambda: None)
        monkeypatch.setattr(jax_native, "_load", lambda: None)
    return request.param


def test_host_functions_match_jax(backend):
    rng = np.random.default_rng(0)
    for n, seed in ((1, 0), (1000, 0), (1000, 7), (4097, 2**40 + 3)):
        np.testing.assert_array_equal(native.make_permutation(n, seed),
                                      jax_native.make_permutation(n, seed))
    data = rng.normal(size=(50, 4, 3)).astype(np.float32)
    perm = rng.permutation(50)[:33]
    np.testing.assert_array_equal(native.shuffled_gather(data, perm),
                                  jax_native.shuffled_gather(data, perm))
    clouds = _clouds(rng)
    for target, seed in ((64, 0), (128, 5)):
        got = native.resample_point_clouds(clouds, target, seed)
        assert got.shape == (len(clouds), target, 3)
        np.testing.assert_array_equal(got, jax_native.resample_point_clouds(clouds, target, seed))
    pred = rng.normal(size=(3, 130, 3)).astype(np.float32)
    gt = rng.normal(size=(3, 77, 3)).astype(np.float32)
    assert native.chamfer_cpu(pred, gt) == jax_native.chamfer_cpu(pred, gt)


@pytest.mark.parametrize("shuffle", [True, False])
def test_loader_batches_match_jax(backend, shuffle):
    rng = np.random.default_rng(1)
    X = rng.random((203, 28, 28, 1), dtype=np.float32)
    y = rng.integers(0, 10, 203)
    got = list(native.NativeBatchLoader(X, y, 32, shuffle=shuffle, seed=11))
    want = list(jax_native.NativeBatchLoader(X, y, 32, shuffle=shuffle, seed=11))
    assert len(got) == len(want) == 6
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_pipeline_native_prefetch_matches_jax():
    """iterate_batches(native_prefetch=True) seeds the loader from the
    caller's Generator as JAX does: the same batches, and the loader's
    batch count rises by one a batch."""
    rng = np.random.default_rng(2)
    X = rng.random((300, 2), dtype=np.float32)
    y = np.arange(300)
    before = native.loader_batches
    got = [(x.numpy(), t.numpy()) for x, t in iterate_batches(
        ArrayDataset(X, y), 64, rng=np.random.default_rng([4, 1]), native_prefetch=True)]
    want = [(np.asarray(x), np.asarray(t)) for x, t in jax_pipeline.iterate_batches(
        jax_pipeline.ArrayDataset(X, y), 64, rng=np.random.default_rng([4, 1]),
        native_prefetch=True)]
    assert native.loader_batches - before == len(got) == len(want) == 4
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)


def test_shapenet_materialize_matches_jax(tmp_path):
    """Clouds of 17 to 250 points resampled to 64 through the library's
    stream in both packages (the port had taken the numpy stream)."""
    rng = np.random.default_rng(3)
    for split in ("train", "test"):
        d = tmp_path / "chair" / split
        d.mkdir(parents=True)
        for i, pts in enumerate(_clouds(rng)):
            np.save(d / f"s{i}.npy", pts)
    for split in ("train", "test"):
        got = shapenet.ShapeNetPointClouds(str(tmp_path), split, num_points=64, seed=9)
        want = jax_shapenet.ShapeNetPointClouds(str(tmp_path), split, num_points=64, seed=9)
        (gx, gy), (wx, wy) = got.materialize(), want.materialize()
        assert gx.shape == (6, 64, 3)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
