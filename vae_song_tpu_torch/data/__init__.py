"""Data loading of the PyTorch port, numpy only (port of
vae_song_tpu/data/__init__.py for the point-cloud datasets)."""

from vae_song_tpu_torch.data import shapenet
from vae_song_tpu_torch.data.pipeline import ArrayDataset, iterate_batches, num_batches


def load_dataset(dataset_name: str, **kwargs):
    """(train ArrayDataset, test ArrayDataset, augment-or-None) for the
    ShapeNet point clouds, with the JAX `load_dataset` keys: `fake`
    (synthetic stand-in clouds: `num_samples` train, default 256, and
    `num_test_samples` test, default a quarter), `shapenet_root`,
    `category`, `num_points`, `seed`. A `fake_` prefix on the name sets
    `fake`. The image and 2-D synthetic datasets are not ported yet."""
    seed = kwargs.get("seed")
    fake = kwargs.get("fake", False)
    if dataset_name.startswith("fake_"):
        dataset_name = dataset_name[len("fake_"):]
        fake = True
    if not dataset_name.startswith("shapenet"):
        raise NotImplementedError(
            f"dataset {dataset_name!r} is not ported to PyTorch yet; see ROADMAP.md "
            "Queue 1 item 10 (the data layer)"
        )
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


__all__ = ["load_dataset", "ArrayDataset", "iterate_batches", "num_batches", "shapenet"]
