"""ShapeNet-like point clouds, numpy only (port of
vae_song_tpu/data/shapenet.py). Copied rather than imported: importing
anything under vae_song_tpu.data runs vae_song_tpu/data/__init__.py,
which imports jax.

Directory layout: <root>/<class_name>/{train|test|val}/**/*.(npz|npy|txt),
each file one shape of [N, 3] points; optional category substring
filter; every cloud is resampled to exactly `num_points` (random
subsample, or pad by random repetition).
"""

import glob
import os

import numpy as np

NPZ_KEYS = ("points", "pc", "pos", "xyz")


def list_point_cloud_files(root, split="train", category=None):
    if not os.path.isdir(root):
        raise FileNotFoundError(f"ShapeNet root directory not found: {root}")
    class_dirs = [
        os.path.join(root, d)
        for d in os.listdir(root)
        if os.path.isdir(os.path.join(root, d))
    ]
    if category is not None:
        class_dirs = [
            d for d in class_dirs if os.path.basename(d).lower().find(category.lower()) != -1
        ]
    files = []
    for cdir in class_dirs:
        split_dir = os.path.join(cdir, split)
        if not os.path.isdir(split_dir):
            continue
        for ext in ("npz", "npy", "txt"):
            files.extend(
                glob.glob(os.path.join(split_dir, "**", f"*.{ext}"), recursive=True)
            )
    if not files:
        example = os.path.join(root, "airplane", split)
        raise FileNotFoundError(
            f"No point cloud files found. Expected structure like: "
            f"{example}/xxx.npy (or .npz/.txt)."
        )
    return sorted(files)


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


def resample_point_clouds(clouds, target: int, seed: int = 0):
    """[len, target, 3] from a list of [n_i, 3] clouds, one numpy
    Generator seeded with `seed` for all of them: the numpy path of the
    JAX package's `data/native.py:resample_point_clouds`. Where the JAX
    package finds its native host library it resamples with that
    library's own stream instead, so clouds that need resampling can
    differ between the packages; clouds of exactly `target` points never
    do."""
    rng = np.random.default_rng(seed)
    out = np.empty((len(clouds), target, clouds[0].shape[1]), np.float32)
    for i, pts in enumerate(clouds):
        out[i] = resample(pts, target, rng)
    return out


class ShapeNetPointClouds:
    """One split of a ShapeNet directory; materialize() stacks it in
    memory (2048 points x 4 B x 3 = 24 KB a shape)."""

    def __init__(self, root, split="train", category=None, num_points=2048, seed=0):
        self.files = list_point_cloud_files(root, split, category)
        self.num_points = num_points
        self.rng = np.random.default_rng(seed)

    def __len__(self):
        return len(self.files)

    def materialize(self):
        """(X [N, num_points, 3] float32, y [N] int64 zeros)."""
        clouds = [load_points(f) for f in self.files]
        X = resample_point_clouds(
            clouds, self.num_points, seed=int(self.rng.integers(2**31 - 1))
        )
        return X, np.zeros(len(self), np.int64)


def fake_point_clouds(n_shapes=256, num_points=2048, seed=0):
    """Synthetic stand-in: unit-sphere surface samples + noise."""
    rng = np.random.default_rng(seed)
    v = rng.standard_normal((n_shapes, num_points, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True) + 1e-8
    scale = rng.uniform(0.5, 1.0, (n_shapes, 1, 1)).astype(np.float32)
    noise = rng.normal(0, 0.02, v.shape).astype(np.float32)
    return v * scale + noise, np.zeros(n_shapes, np.int64)
