"""Synthetic 2-D datasets, pure numpy (a copy of
vae_song_tpu/data/synthetic.py: importing the JAX package's data module
would import jax). The same `np.random.default_rng` draws give the same
arrays bit for bit.

Each generator returns (X float32 [N, 2], y float32/int64 [N]).
Seeding is explicit (np.random.default_rng) instead of the reference's
global np.random state.
"""

import numpy as np


def generate_weights_from_pattern(pattern, num_targets, K=None, rng=None):
    """Mixture-weight generator (dataset.py:10-69)."""
    rng = rng or np.random.default_rng()
    if pattern == "uniform":
        return [1.0] * num_targets
    if pattern == "corner_heavy":
        weights = np.ones(num_targets, dtype=np.float32) * 0.1
        if K is not None and num_targets == K * K:
            weights[0] = 100.0
            weights[K - 1] = 50.0
            weights[(K - 1) * K] = 50.0
            weights[K * K - 1] = 20.0
        else:
            weights[0] = 100.0
            if num_targets > 1:
                weights[num_targets - 1] = 50.0
        return (weights / weights.sum()).tolist()
    if pattern == "center_heavy":
        weights = np.ones(num_targets, dtype=np.float32) * 0.1
        if K is not None and num_targets == K * K:
            if K % 2 == 0:
                coords = [
                    (K / 2 - 1, K / 2 - 1),
                    (K / 2 - 1, K / 2),
                    (K / 2, K / 2 - 1),
                    (K / 2, K / 2),
                ]
            else:
                coords = [(K // 2, K // 2)]
            for cx, cy in coords:
                idx = int(cy * K + cx)
                if 0 <= idx < num_targets:
                    weights[idx] = 100.0
        else:
            mid = num_targets // 2
            weights[mid] = 100.0
            if num_targets > 1 and mid + 1 < num_targets:
                weights[mid + 1] = 80.0
            if num_targets > 2 and mid - 1 >= 0:
                weights[mid - 1] = 80.0
        return (weights / weights.sum()).tolist()
    if pattern == "sparse_random":
        w = rng.exponential(scale=1.0, size=(num_targets,))
        return (w / w.sum()).tolist()
    raise ValueError(f"Unknown distribution pattern: {pattern}")


def generate_spin_data(num_data=10000, num_classes=5, spiral=0.6, rng=None):
    """5-class log-spaced spiral ('pinwheel', dataset.py:118-161)."""
    rng = rng or np.random.default_rng()
    features, labels = [], []
    points_per_class = num_data // num_classes
    max_radius, noise_std = 3.0, 0.1
    for class_idx in range(num_classes):
        base_angle = 2 * np.pi * class_idx / num_classes
        radii = np.exp(np.linspace(0, np.log(max_radius), points_per_class))
        angles = base_angle + spiral * radii
        radii = radii + rng.normal(0, noise_std * radii, points_per_class)
        angles = angles + rng.normal(0, noise_std, points_per_class)
        x = radii * np.cos(angles)
        y = radii * np.sin(angles)
        features.append(np.column_stack([x, y]))
        labels.append(np.full(points_per_class, class_idx))
    features = np.concatenate(features).astype(np.float32)
    labels = np.concatenate(labels).astype(np.float32)
    perm = rng.permutation(len(features))
    return features[perm], labels[perm]


def generate_pinwheel_data_legacy(
    radial_std, tangential_std, num_classes, num_per_class, rate, rng=None
):
    """True pinwheel generator kept by the reference (dataset.py:168-196)."""
    rng = rng or np.random.default_rng()
    rads = np.linspace(0, 2 * np.pi, num_classes, endpoint=False)
    features, labels = [], []
    for class_number in range(num_classes):
        r = rng.normal(loc=1, scale=radial_std, size=num_per_class)
        t = rng.normal(loc=rads[class_number], scale=tangential_std, size=num_per_class)
        features.append(np.column_stack([r * np.cos(t), r * np.sin(t)]))
        labels.append(np.full(num_per_class, class_number))
    features = np.concatenate(features).astype(np.float32)
    labels = np.concatenate(labels).astype(np.float32)
    rot = np.array([[np.cos(rate), -np.sin(rate)], [np.sin(rate), np.cos(rate)]])
    return features @ rot, labels


def generate_chessboard_data(n_data, chessboard_size=4, rng=None):
    """Rejection-sampled black-square points (dataset.py:84-102)."""
    rng = rng or np.random.default_rng()
    X = rng.random((int(n_data * 2), 2))
    grid = (X * chessboard_size).astype(int)
    mask = (grid[:, 0] + grid[:, 1]) % 2 == 1
    X_sel = X[mask]
    while X_sel.shape[0] < n_data:
        extra = rng.random((n_data, 2))
        grid_e = (extra * chessboard_size).astype(int)
        mask_e = (grid_e[:, 0] + grid_e[:, 1]) % 2 == 1
        X_sel = np.vstack([X_sel, extra[mask_e]])
    X_sel = X_sel[:n_data]
    grid_sel = (X_sel * chessboard_size).astype(int)
    labels = (grid_sel[:, 0] + grid_sel[:, 1] * chessboard_size).astype(np.float32)
    return X_sel.astype(np.float32), labels


def generate_grid_mixture(K, N0, std=0.1, L=1.0, rng=None):
    """KxK uniform grid of Gaussians (dataset.py:199-232)."""
    rng = rng or np.random.default_rng()
    centers = np.linspace(0, L, K)
    points, labels = [], []
    for idx, (cx, cy) in enumerate((x, y) for x in centers for y in centers):
        pts = rng.standard_normal((N0, 2)) * std + np.array([cx, cy])
        points.append(pts)
        labels.append(np.full(N0, idx))
    return (
        np.vstack(points).astype(np.float32),
        np.concatenate(labels).astype(np.int64),
    )


def _distribute_counts(weights, total, rng):
    weights = np.asarray(weights, np.float64)
    weights = weights / weights.sum()  # exact-sum for rng.choice's p check
    counts = (weights * total).astype(int)
    remainder = total - counts.sum()
    if remainder != 0:
        idxs = rng.choice(len(weights), size=abs(remainder), replace=True, p=weights)
        for i in idxs:
            counts[i] += 1 if remainder > 0 else -1
            if counts[i] < 0:
                counts[i] = 0
    return counts


def generate_weighted_grid_mixture(
    K, total_samples, std=0.1, L=1.0, weights=None, pattern="uniform", seed=None
):
    """KxK grid with weighted per-cell counts (dataset.py:235-307)."""
    rng = np.random.default_rng(seed)
    num_cells = K * K
    if weights is None:
        w = np.array(generate_weights_from_pattern(pattern, num_cells, K=K, rng=rng))
    else:
        w = np.array(weights, dtype=np.float32)
        w = w / w.sum()
    centers = np.linspace(0, L, K)
    cell_centers = [(x, y) for x in centers for y in centers]
    counts = _distribute_counts(w, total_samples, rng)
    points, labels = [], []
    for idx in range(num_cells):
        cnt = counts[idx]
        if cnt <= 0:
            continue
        cx, cy = cell_centers[idx]
        points.append(rng.standard_normal((cnt, 2)) * std + np.array([cx, cy]))
        labels.append(np.full(cnt, idx))
    if not points:
        return np.empty((0, 2), np.float32), np.empty((0,), np.int64)
    return (
        np.vstack(points).astype(np.float32),
        np.concatenate(labels).astype(np.int64),
    )


def generate_random_gaussian_mixture(
    num_components, total_samples, weights=None, std=0.1, L=1.0, seed=None
):
    """Random-center GMM (dataset.py:310-359 — deprecated upstream in
    favor of the simple mixture; kept for inventory parity).
    Remainder samples go to the first component, as upstream."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0, L, size=(num_components, 2))
    if weights is None:
        w = np.ones(num_components, np.float32) / num_components
    else:
        w = np.array(weights, np.float32)
        w = w / w.sum()
    counts = (w * total_samples).astype(int)
    counts[0] += total_samples - counts.sum()
    points, labels = [], []
    for idx in range(num_components):
        if counts[idx] <= 0:
            continue
        points.append(rng.standard_normal((counts[idx], 2)) * std + centers[idx])
        labels.append(np.full(counts[idx], idx))
    return (
        np.vstack(points).astype(np.float32),
        np.concatenate(labels).astype(np.int64),
    )


def generate_simple_gaussian_mixture(
    num_components,
    total_samples,
    centers=None,
    center_range=4.0,
    stds=None,
    weights=None,
    pattern="uniform",
    seed=None,
):
    """Random-center GMM with pattern weights (dataset.py:362-454).

    Returns (X, y, centers, stds, weights)."""
    rng = np.random.default_rng(seed)
    if centers is None:
        centers = rng.uniform(0, center_range, size=(num_components, 2))
    else:
        centers = np.array(centers)
    if stds is None:
        stds = [0.2] * num_components
    elif isinstance(stds, (int, float)):
        stds = [stds] * num_components
    stds = np.array(stds)
    if weights is None:
        weights = generate_weights_from_pattern(pattern, num_components, rng=rng)
    weights = np.array(weights)
    weights = weights / weights.sum()
    counts = _distribute_counts(weights, total_samples, rng)
    points, labels = [], []
    for i in range(num_components):
        if counts[i] <= 0:
            continue
        samples = rng.normal(centers[i], stds[i], size=(counts[i], 2))
        points.append(samples)
        labels.append(np.full(counts[i], i))
    if not points:
        return (
            np.empty((0, 2), np.float32),
            np.empty((0,), np.int64),
            centers,
            stds,
            weights,
        )
    X = np.vstack(points).astype(np.float32)
    y = np.concatenate(labels).astype(np.int64)
    return X, y, centers, stds, weights
