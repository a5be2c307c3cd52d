"""The port's image grids and PCA (vae_song_tpu_torch/viz) against the JAX
package's: save_image_grid's PNGs read back with matplotlib pixel for
pixel, pca_calculation on the same arrays bit for bit, and the files
pca_visualization and visualize_flows write."""

import os

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

from vae_song_tpu.viz import pca as jax_pca
from vae_song_tpu.viz import plots as jax_plots
from vae_song_tpu_torch.viz import pca, plots


@pytest.mark.parametrize("shape,nrow,normalize", [
    ((20, 28, 28, 1), 16, True), ((7, 32, 32, 3), 4, True), ((5, 8, 6, 3), 2, False),
    ((1, 28, 28, 1), 1, True)])
def test_image_grid_pixels_match_jax(tmp_path, shape, nrow, normalize):
    x = np.random.default_rng(shape[0]).random(shape, dtype=np.float32) * 1.2 - 0.1
    plots.save_image_grid(torch.from_numpy(x), str(tmp_path / "port.png"), nrow=nrow,
                          normalize=normalize)
    jax_plots.save_image_grid(x, str(tmp_path / "jax.png"), nrow=nrow, normalize=normalize)
    got, want = plt.imread(tmp_path / "port.png"), plt.imread(tmp_path / "jax.png")
    rows = -(-shape[0] // nrow)
    assert got.shape[:2] == (rows * (shape[1] + 2) + 2, nrow * (shape[2] + 2) + 2)
    np.testing.assert_array_equal(got, want)


def test_pca_calculation_matches_jax():
    x = np.random.default_rng(0).normal(size=(300, 6)).astype(np.float32) * [1, 2, 3, 1, 5, 1]
    got = pca.pca_calculation(torch.from_numpy(x))
    want = jax_pca.pca_calculation(x)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


def test_pca_visualization_writes_its_plots(tmp_path, monkeypatch):
    """mu and z = mu + eps exp(log_var / 2) with the given eps; t-SNE
    skipped (no scikit-learn: it prints and goes on)."""
    monkeypatch.setitem(__import__("sys").modules, "sklearn", None)
    rng = np.random.default_rng(1)
    x = rng.random((40, 3), dtype=np.float32)
    y = rng.integers(0, 10, 40)
    eps = rng.normal(size=(40, 2)).astype(np.float32)
    seen = {}

    def encode(xx):
        seen["x"] = xx
        return torch.from_numpy(xx[:, :2] * 2), torch.from_numpy(xx[:, 1:] - 1)

    pca.pca_visualization(encode, x, y, eps, 0, "run", "res", root=str(tmp_path))
    np.testing.assert_array_equal(seen["x"], x)
    written = sorted(os.listdir(tmp_path / "results" / "res" / "run" / "pca"))
    assert written == sorted(["prior.png"] + [f"0_{kind}_{v}.png" for v in ("mu", "z") for kind in
                                              ("pca_all", "channels_all", "pca_v")])


def test_visualize_flows_writes_its_plot(tmp_path):
    a = np.random.default_rng(2).normal(size=(10, 2))
    plots.visualize_flows(torch.from_numpy(a), a * 2, a - 1, a, "res", "run", 3,
                          root=str(tmp_path))
    assert os.listdir(tmp_path / "results" / "res" / "run" / "visualize_flows") == [
        "3_flows.png"]
