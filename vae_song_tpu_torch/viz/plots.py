"""Point-cloud export (port of vae_song_tpu/viz/plots.py:save_point_cloud;
the plotting functions there need matplotlib and are not ported)."""

import numpy as np
import torch


def save_point_cloud(points, filepath):
    """Save a [N, 3] cloud as `filepath`.npy and as ASCII `filepath`.ply
    (the format the reference writes through open3d)."""
    if isinstance(points, torch.Tensor):
        points = points.detach().float().cpu().numpy()
    points = np.asarray(points)
    np.save(filepath + ".npy", points)
    with open(filepath + ".ply", "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(points)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in points:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")
