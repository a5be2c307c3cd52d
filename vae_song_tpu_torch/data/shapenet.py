"""ShapeNet-like point clouds, numpy only (the parts of
vae_song_tpu/data/shapenet.py the port's inference path uses). Copied
rather than imported: importing anything under vae_song_tpu.data runs
vae_song_tpu/data/__init__.py, which imports jax."""

import os

import numpy as np

NPZ_KEYS = ("points", "pc", "pos", "xyz")


def load_points(path):
    """[N, 3] float32 points from one .npz / .npy / .txt file."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npz":
        data = np.load(path)
        for k in NPZ_KEYS:
            if k in data:
                pts = data[k]
                break
        else:
            raise KeyError(f"No 'points' array found in {path}")
    elif ext == ".npy":
        pts = np.load(path)
    elif ext == ".txt":
        pts = np.loadtxt(path).astype(np.float32)
    else:
        raise ValueError(f"Unsupported file extension: {ext}")
    if pts.ndim != 2 or pts.shape[1] != 3:
        raise ValueError(f"Point array must be [N,3], got {pts.shape} from {path}")
    return pts.astype(np.float32)


def resample(pts, num_points, rng=None):
    """Exactly `num_points` points: random subsample, or pad by random
    repetition."""
    rng = rng or np.random.default_rng()
    n = pts.shape[0]
    if n == num_points:
        return pts
    if n > num_points:
        idx = rng.choice(n, num_points, replace=False)
        return pts[idx]
    idx = rng.choice(n, num_points - n, replace=True)
    return np.concatenate([pts, pts[idx]], axis=0)


def fake_point_clouds(n_shapes=256, num_points=2048, seed=0):
    """Synthetic stand-in: unit-sphere surface samples + noise."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_shapes, num_points, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8
    scale = rng.uniform(0.5, 1.0, (n_shapes, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.02, v.shape).astype(np.float32)
    return v * scale + noise, np.zeros(n_shapes, np.int64)
