"""Data loading of the PyTorch port (port of vae_song_tpu/data/__init__.py):
the image datasets, the synthetic 2-D datasets and the point clouds."""

import numpy as np

from vae_song_tpu_torch.data import images, shapenet, synthetic
from vae_song_tpu_torch.data.pipeline import ArrayDataset, iterate_batches, num_batches

IMAGE_DATASETS = ("mnist", "fashionmnist", "cifar10", "omniglot", "celeba")


def load_dataset(dataset_name: str, **kwargs):
    """(train ArrayDataset, test ArrayDataset, augment-or-None) with the
    JAX `load_dataset` keys and draws:

      * pinwheel, chessboard: 10000 train and 10000 test points from one
        `default_rng(seed)`;
      * grid_mixture (`K`, `train_total`, `std`, `distribution_pattern`,
        `train_weights`, `test_N0`; the test grid from seed + 1) and
        simple_gaussian_mixture (`num_components`, `rgm_total`,
        `rgm_std`, `rgm_L`, `rgm_centers`, `rgm_weights`);
      * ShapeNet point clouds: `fake` (synthetic stand-in clouds:
        `num_samples` train, default 256, and `num_test_samples` test,
        default a quarter), `shapenet_root`, `category`, `num_points`;
      * the image datasets (data/images.py): the files under
        $VST_DATA_ROOT, or with `fake` the 4096 train and 1024 test
        stand-in images from `seed` (default 0); the augment is MNIST's
        rotation and crop, or CIFAR-10's and CelebA's flip, None for
        the others.

    `seed=None` draws fresh entropy, as in JAX. A `fake_` prefix on the
    name sets `fake`."""
    pattern = kwargs.get("distribution_pattern", "uniform")
    num_components = kwargs.get("num_components", 16)
    total_samples = kwargs.get("train_total", 10000)
    std = kwargs.get("std", 0.1)
    K = kwargs.get("K", 16)
    seed = kwargs.get("seed")
    fake = kwargs.get("fake", False)
    if dataset_name.startswith("fake_"):
        dataset_name = dataset_name[len("fake_"):]
        fake = True

    if dataset_name in IMAGE_DATASETS:
        (xtr, ytr), (xte, yte) = images.load_image_dataset(dataset_name, fake=fake,
                                                           seed=seed or 0)
        aug_factory = images.AUGMENTATIONS.get(dataset_name)
        aug = aug_factory() if aug_factory else None
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), aug

    if dataset_name == "pinwheel":
        rng = np.random.default_rng(seed)
        xtr, ytr = synthetic.generate_spin_data(10000, 5, rng=rng)
        xte, yte = synthetic.generate_spin_data(10000, 5, rng=rng)
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), None

    if dataset_name == "chessboard":
        rng = np.random.default_rng(seed)
        xtr, ytr = synthetic.generate_chessboard_data(10000, rng=rng)
        xte, yte = synthetic.generate_chessboard_data(10000, rng=rng)
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), None

    if dataset_name == "grid_mixture":
        train_weights = kwargs.get("train_weights")
        test_N0 = kwargs.get("test_N0")
        if pattern == "uniform" and train_weights is None:
            xtr, ytr = synthetic.generate_grid_mixture(
                K, total_samples // (K * K), std=std, L=1.0, rng=np.random.default_rng(seed))
        else:
            xtr, ytr = synthetic.generate_weighted_grid_mixture(
                K, total_samples, std=std, L=1.0, weights=train_weights, pattern=pattern,
                seed=seed)
        test_rng = np.random.default_rng(None if seed is None else seed + 1)
        xte, yte = synthetic.generate_grid_mixture(
            K, test_N0 if test_N0 is not None else (total_samples // (K * K)),
            std=std, L=1.0, rng=test_rng)
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), None

    if dataset_name == "simple_gaussian_mixture":
        rgm_total = kwargs.get("rgm_total")
        rgm_std = kwargs.get("rgm_std")
        rgm_L = kwargs.get("rgm_L")
        common = dict(
            num_components=num_components,
            total_samples=rgm_total if rgm_total is not None else total_samples,
            center_range=rgm_L if rgm_L is not None else K,
            stds=rgm_std if rgm_std is not None else std,
            seed=seed,
        )
        xtr, ytr, *_ = synthetic.generate_simple_gaussian_mixture(
            centers=kwargs.get("rgm_centers"), weights=kwargs.get("rgm_weights"),
            pattern=pattern, **common)
        xte, yte, *_ = synthetic.generate_simple_gaussian_mixture(pattern="uniform", **common)
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), None

    if dataset_name.startswith("shapenet"):
        root = kwargs.get("shapenet_root", "dataset/shapenet")
        category = kwargs.get("category")
        num_points = kwargs.get("num_points", 2048)
        if fake:
            n_train = int(kwargs.get("num_samples", 256))
            n_test = int(kwargs.get("num_test_samples", max(1, n_train // 4)))
            xtr, ytr = shapenet.fake_point_clouds(n_train, num_points, seed=seed or 0)
            xte, yte = shapenet.fake_point_clouds(n_test, num_points, seed=(seed or 0) + 1)
        else:
            xtr, ytr = shapenet.ShapeNetPointClouds(
                root, "train", category, num_points, seed=seed or 0).materialize()
            xte, yte = shapenet.ShapeNetPointClouds(
                root, "test", category, num_points, seed=seed or 0).materialize()
        return ArrayDataset(xtr, ytr), ArrayDataset(xte, yte), None

    raise NotImplementedError(f"{dataset_name} is not implemented")


__all__ = ["load_dataset", "ArrayDataset", "iterate_batches", "num_batches", "images",
           "shapenet", "synthetic"]
