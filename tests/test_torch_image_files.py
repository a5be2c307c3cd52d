"""The port's image readers on files against the JAX package's: the IDX
(MNIST, FashionMNIST, gzipped too), CIFAR-10 pickle and CelebA / Omniglot
folder fixtures that scripts/make_{idx,cifar,folder}_fixture.py write,
read through both packages' `load_dataset` with the data root pointed at
them, bitwise equal; and the folder reader without PIL."""

import gzip
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

from vae_song_tpu import data as jax_data
from vae_song_tpu.data import images as jax_images
from vae_song_tpu_torch import data
from vae_song_tpu_torch.data import images

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name, *args):
    """scripts/<name> run in this process with these arguments."""
    argv = sys.argv
    sys.argv = [name, *args]
    try:
        runpy.run_path(os.path.join(REPO, "scripts", name), run_name="__main__")
    finally:
        sys.argv = argv


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One data root holding every fixture, small."""
    out = tmp_path_factory.mktemp("images")
    for d in ("MNIST", "FashionMNIST"):
        _script("make_idx_fixture.py", "--out", str(out / d / "raw"), "--n_train", "96",
                "--n_test", "24", "--seed", "0" if d == "MNIST" else "1")
    _script("make_cifar_fixture.py", "--out", str(out),
            "--n_train", "100", "--n_test", "20", "--seed", "0")
    _script("make_folder_fixture.py", "--dataset", "celeba", "--out", str(out),
            "--count", "20", "--seed", "0")
    _script("make_folder_fixture.py", "--dataset", "omniglot", "--out", str(out),
            "--alphabets", "2", "--chars", "2", "--samples", "2", "--seed", "0")
    return out


def _both(monkeypatch, root, name):
    monkeypatch.setattr(images, "DATA_ROOT", str(root))
    monkeypatch.setattr(jax_images, "DATA_ROOT", str(root))
    return data.load_dataset(name), jax_data.load_dataset(name)


@pytest.mark.parametrize("name", sorted(images.IMAGE_SHAPES))
def test_files_read_as_jax_reads_them(root, monkeypatch, name):
    got, want = _both(monkeypatch, root, name)
    for g, w in zip(got[:2], want[:2]):
        assert len(g) > 0 and g.X.shape[1:] == images.IMAGE_SHAPES[name]
        assert g.X.dtype == w.X.dtype == np.float32 and g.y.dtype == w.y.dtype == np.int64
        np.testing.assert_array_equal(g.X, w.X)
        np.testing.assert_array_equal(g.y, w.y)
    assert (got[2] is None) == (want[2] is None)


def test_gzipped_idx_files(root, monkeypatch, tmp_path):
    """The IDX reader opens `<file>.gz` where the plain file is missing."""
    gz = tmp_path / "MNIST" / "raw"
    gz.mkdir(parents=True)
    for f in os.listdir(root / "MNIST" / "raw"):
        with open(root / "MNIST" / "raw" / f, "rb") as src, gzip.open(gz / f"{f}.gz", "wb") as dst:
            shutil.copyfileobj(src, dst)
    got, want = _both(monkeypatch, tmp_path, "mnist")
    plain, _ = _both(monkeypatch, root, "mnist")
    for g, w, p in zip(got[:2], want[:2], plain[:2]):
        np.testing.assert_array_equal(g.X, w.X)
        np.testing.assert_array_equal(g.X, p.X)


def test_folder_reader_without_pil_names_it(root, monkeypatch):
    monkeypatch.setattr(images, "DATA_ROOT", str(root))
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(FileNotFoundError, match="PIL"):
        data.load_dataset("celeba")
