"""Artifact exports (port of vae_song_tpu/viz/plots.py: save_point_cloud,
visualize_2c_points_on_image and the Lipschitz CLI's plot_heatmap,
plot_2d_histogram and logscale_plt_color_map; the other plots wait for
ROADMAP.md Queue 1 items 10b and 13). matplotlib is imported inside each
plotting function, so the module imports where matplotlib is not
installed, and a plot raises ImportError there."""

import os

import numpy as np
import torch


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().cpu().numpy()
    return np.asarray(x)


def save_point_cloud(points, filepath):
    """Save a [N, 3] cloud as `filepath`.npy and as ASCII `filepath`.ply
    (the format the reference writes through open3d)."""
    points = _np(points)
    np.save(filepath + ".npy", points)
    with open(filepath + ".ply", "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def visualize_2c_points_on_image(points, label, resultname, name, epoch, tensor_name="recon",
                                 root="."):
    """2-D scatter coloured by class (utils.py:427-450), written to
    `<root>/results/<resultname>/<name>/scatter2d/{epoch}_{tensor_name}.png`.
    Raises ImportError where matplotlib is not installed."""
    plt = _pyplot()
    points = _np(points)
    label = _np(label)
    if points.ndim == 3:
        points = points.reshape(-1, points.shape[-1])
        label = np.tile(label, points.shape[0] // max(1, label.shape[0]))[: points.shape[0]]
    assert points.shape[1] == 2, f"Tensor must have shape [N, 2], got {points.shape}"
    fontsize = 16
    fig = plt.figure(figsize=(8, 8))
    plt.scatter(points[:, 0], points[:, 1], c=label, cmap="tab10", marker="o")
    plt.title(tensor_name, fontsize=fontsize)
    plt.xticks(fontsize=fontsize)
    plt.yticks(fontsize=fontsize)
    plt.grid(False)
    outdir = os.path.join(root, "results", resultname, name, "scatter2d")
    os.makedirs(outdir, exist_ok=True)
    plt.savefig(os.path.join(outdir, f"{epoch}_{tensor_name}.png"), bbox_inches="tight",
                pad_inches=0.1)
    plt.close(fig)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def logscale_plt_color_map(original_cmap_name):
    """Log-scaled colormap (utils.py:188-192)."""
    import matplotlib

    origin = matplotlib.colormaps[original_cmap_name].resampled(256)
    newcolors = origin(np.logspace(0, 1, 256) / 10)
    return matplotlib.colors.ListedColormap(newcolors)


def plot_heatmap(vals, K, title, filepath, cmap="viridis", extent=None):
    """K x K heatmap of a flat array (utils.py:569-593)."""
    plt = _pyplot()
    arr = np.array(_np(vals)).reshape(K, K)
    plt.figure(figsize=(8, 6))
    plt.imshow(arr, cmap=cmap, origin="lower", extent=extent, aspect="equal")
    plt.colorbar()
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    plt.savefig(filepath, bbox_inches="tight", pad_inches=0)
    plt.close()


def plot_2d_histogram(X, bins=16, title="2D Data Distribution", filepath="histogram.png",
                      cmap="viridis", xlim=None, ylim=None):
    """2-D histogram dump (utils.py:595-636); returns the plotted extent."""
    plt = _pyplot()
    X = _np(X)
    plt.figure(figsize=(8, 6))
    _, xedges, yedges, _ = plt.hist2d(X[:, 0], X[:, 1], bins=bins, cmap=cmap)
    plt.colorbar()
    actual_xmin, actual_xmax = xedges[0], xedges[-1]
    actual_ymin, actual_ymax = yedges[0], yedges[-1]
    if xlim is not None:
        plt.xlim(xlim)
        actual_xmin, actual_xmax = xlim
    if ylim is not None:
        plt.ylim(ylim)
        actual_ymin, actual_ymax = ylim
    os.makedirs(os.path.dirname(filepath) or ".", exist_ok=True)
    plt.savefig(filepath, bbox_inches="tight", pad_inches=0)
    plt.close()
    return (actual_xmin, actual_xmax, actual_ymin, actual_ymax)
