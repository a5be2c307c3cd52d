"""Image datasets and their augments (port of vae_song_tpu/data/images.py;
copied, not imported: the JAX file imports jax).

The readers are the JAX package's, numpy only (no torchvision):
  * MNIST / FashionMNIST from the standard IDX files under
    `<root>/<NAME>/raw/` (the torchvision layout), `<root>/<NAME>/`,
    `<root>/<name>/` or `<root>`, gzipped or not;
  * CIFAR-10 from the python-pickle batches;
  * CelebA and Omniglot from local image folders (needs PIL);
  * `fake=True` (or a dataset named 'fake_<name>'): shape-correct smooth
    random blobs, the same numpy draws as JAX.
`<root>` is $VST_DATA_ROOT, default `dataset`. Images are NHWC float32 in
[0, 1].

The augments run on the device on NHWC torch tensors, one batch a call.
JAX draws them from its PRNG, which torch cannot reproduce, so their
randomness is an explicit input (the draws) and `draw` takes it from a
torch.Generator, on the CPU so that the draws do not depend on the device:
  * MNIST: RandomRotation(20) + RandomResizedCrop((28, 28), (0.9, 1),
    (0.9, 1.1)) (dataset.py:475-479) as one inverse affine map a image,
    sampled bilinearly with zeros outside the image;
  * CIFAR-10 and CelebA: a random horizontal flip (dataset.py:488, 508).
"""

import gzip
import math
import os
import struct

import numpy as np
import torch
import torch.nn.functional as F

DATA_ROOT = os.environ.get("VST_DATA_ROOT", "dataset")

IMAGE_SHAPES = {
    "mnist": (28, 28, 1),
    "fashionmnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "omniglot": (28, 28, 1),
    "celeba": (64, 64, 3),
}


def _open_maybe_gz(path):
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return open(path, "rb")


def _read_idx_images(path):
    with _open_maybe_gz(path) as f:
        magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
        assert magic == 2051, f"bad IDX image magic in {path}"
        data = np.frombuffer(f.read(n * rows * cols), dtype=np.uint8)
    return data.reshape(n, rows, cols, 1).astype(np.float32) / 255.0


def _read_idx_labels(path):
    with _open_maybe_gz(path) as f:
        magic, n = struct.unpack(">II", f.read(8))
        assert magic == 2049, f"bad IDX label magic in {path}"
        return np.frombuffer(f.read(n), dtype=np.uint8).astype(np.int64)


def _find_idx_root(name: str):
    dirname = {"mnist": "MNIST", "fashionmnist": "FashionMNIST"}[name]
    candidates = [
        os.path.join(DATA_ROOT, dirname, "raw"),
        os.path.join(DATA_ROOT, dirname),
        os.path.join(DATA_ROOT, name),
        DATA_ROOT,
    ]
    for c in candidates:
        if os.path.exists(os.path.join(c, "train-images-idx3-ubyte")) or os.path.exists(
            os.path.join(c, "train-images-idx3-ubyte.gz")
        ):
            return c
    return None


def load_idx_dataset(name: str):
    root = _find_idx_root(name)
    if root is None:
        raise FileNotFoundError(
            f"No IDX files for '{name}' under {DATA_ROOT!r} (no download in this "
            f"environment). Use fake=True for synthetic stand-in data."
        )
    xtr = _read_idx_images(os.path.join(root, "train-images-idx3-ubyte"))
    ytr = _read_idx_labels(os.path.join(root, "train-labels-idx1-ubyte"))
    xte = _read_idx_images(os.path.join(root, "t10k-images-idx3-ubyte"))
    yte = _read_idx_labels(os.path.join(root, "t10k-labels-idx1-ubyte"))
    return (xtr, ytr), (xte, yte)


def load_cifar10():
    import pickle

    root = None
    for c in [os.path.join(DATA_ROOT, "cifar-10-batches-py"), DATA_ROOT]:
        if os.path.exists(os.path.join(c, "data_batch_1")):
            root = c
            break
    if root is None:
        raise FileNotFoundError(f"No CIFAR-10 batches under {DATA_ROOT!r}. Use fake=True.")

    def _load(fname):
        with open(os.path.join(root, fname), "rb") as f:
            d = pickle.load(f, encoding="bytes")
        x = d[b"data"].reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1)
        return x.astype(np.float32) / 255.0, np.array(d[b"labels"], np.int64)

    xs, ys = zip(*[_load(f"data_batch_{i}") for i in range(1, 6)])
    xte, yte = _load("test_batch")
    return (np.concatenate(xs), np.concatenate(ys)), (xte, yte)


def load_image_folder(name: str, max_items: int | None = None):
    """CelebA / Omniglot from local image folders (needs PIL).

    CelebA: <root>/celeba/img_align_celeba/*.jpg with the reference's
    CenterCrop(148) + Resize(64) (dataset.py:486-495; PIL's default
    resample, as in JAX), the last tenth as the test split.
    Omniglot: <root>/omniglot-py/images_background/** (train) and
    images_evaluation/** (test), resized to 28 (dataset.py:515-523)."""
    try:
        from PIL import Image
    except ImportError as e:
        raise FileNotFoundError(f"PIL unavailable for image-folder loading: {e}")

    if name == "celeba":
        root = None
        for c in [os.path.join(DATA_ROOT, "celeba", "img_align_celeba"),
                  os.path.join(DATA_ROOT, "img_align_celeba")]:
            if os.path.isdir(c):
                root = c
                break
        if root is None:
            raise FileNotFoundError(f"No CelebA image folder under {DATA_ROOT!r}.")
        files = sorted(f for f in os.listdir(root) if f.lower().endswith((".jpg", ".png")))
        if max_items:
            files = files[:max_items]

        def load_one(fname):
            img = Image.open(os.path.join(root, fname)).convert("RGB")
            w, h = img.size
            left, top = (w - 148) // 2, (h - 148) // 2
            img = img.crop((left, top, left + 148, top + 148)).resize((64, 64))
            return np.asarray(img, np.float32) / 255.0

        xs = np.stack([load_one(f) for f in files])
        n_test = max(1, len(xs) // 10)
        ys = np.zeros(len(xs), np.int64)
        return (xs[:-n_test], ys[:-n_test]), (xs[-n_test:], ys[-n_test:])

    if name == "omniglot":
        base = os.path.join(DATA_ROOT, "omniglot-py")
        tr_dir = os.path.join(base, "images_background")
        te_dir = os.path.join(base, "images_evaluation")
        if not os.path.isdir(tr_dir):
            raise FileNotFoundError(f"No Omniglot folders under {base!r}.")

        def load_split(d):
            xs, ys = [], []
            label = 0
            for alphabet in sorted(os.listdir(d)):
                adir = os.path.join(d, alphabet)
                if not os.path.isdir(adir):
                    continue
                for character in sorted(os.listdir(adir)):
                    cdir = os.path.join(adir, character)
                    for f in sorted(os.listdir(cdir)):
                        img = Image.open(os.path.join(cdir, f)).convert("L").resize((28, 28))
                        xs.append(np.asarray(img, np.float32)[..., None] / 255.0)
                        ys.append(label)
                    label += 1
            return np.stack(xs), np.array(ys, np.int64)

        return load_split(tr_dir), load_split(te_dir)

    raise ValueError(f"load_image_folder does not handle {name}")


def fake_image_dataset(name: str, n_train=4096, n_test=1024, seed=0):
    """Shape-correct synthetic images: smooth random blobs in [0, 1]."""
    h, w, c = IMAGE_SHAPES[name]
    rng = np.random.default_rng(seed)

    def make(n):
        # a sum of three random 2-D Gaussians: image-like smooth content
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        imgs = np.zeros((n, h, w, c), np.float32)
        cx = rng.uniform(0, w, (n, 3))
        cy = rng.uniform(0, h, (n, 3))
        s = rng.uniform(2, 6, (n, 3))
        a = rng.uniform(0.4, 1.0, (n, 3))
        for k in range(3):
            g = a[:, k, None, None] * np.exp(
                -(
                    (xx[None] - cx[:, k, None, None]) ** 2
                    + (yy[None] - cy[:, k, None, None]) ** 2
                )
                / (2 * s[:, k, None, None] ** 2)
            )
            imgs += g[..., None]
        imgs = np.clip(imgs, 0, 1)
        labels = rng.integers(0, 10, n).astype(np.int64)
        return imgs, labels

    return make(n_train), make(n_test)


# ---------------------------------------------------------------- augments


def rotation_crop_matrices(draws: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """[b, 2, 3] float32 inverse affine maps, output (y, x, 1) -> input
    (y, x), of RandomRotation + RandomResizedCrop (JAX
    `_rotation_crop_matrix`): the crop of the rotated image, in
    torchvision's RandomRotation -> RandomResizedCrop order. `draws` [b, 5]:
    the angle in degrees, the area scale, the log aspect ratio, and the
    crop's top and left offsets as fractions of the room left."""
    d = draws.to(torch.float32)
    angle = d[:, 0] * math.pi / 180.0
    ratio = torch.exp(d[:, 2])
    crop_h = torch.clamp(torch.sqrt(d[:, 1] / ratio) * h, max=h)
    crop_w = torch.clamp(torch.sqrt(d[:, 1] * ratio) * w, max=w)
    top = d[:, 3] * (h - crop_h)
    left = d[:, 4] * (w - crop_w)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    cos, sin = torch.cos(angle), torch.sin(angle)
    # map output [0, h-1] onto the crop window [top, top + crop_h - 1],
    # then undo the rotation about the centre: m = [R S | R (t - c) + c]
    sy = (crop_h - 1.0) / (h - 1.0)
    sx = (crop_w - 1.0) / (w - 1.0)
    ty, tx = top - cy, left - cx
    return torch.stack([
        torch.stack([cos * sy, -sin * sx, cos * ty - sin * tx + cy], dim=-1),
        torch.stack([sin * sy, cos * sx, sin * ty + cos * tx + cx], dim=-1),
    ], dim=1)


def affine_warp(batch: torch.Tensor, matrices: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of each NHWC image at its map's input coordinates,
    0 outside the image (JAX: map_coordinates(order=1, mode="constant")
    gives each out-of-range corner 0, as grid_sample's zero padding does);
    (y, x) becomes grid_sample's (x, y) normalised by (W - 1) and (H - 1)."""
    b, h, w, _ = batch.shape
    m = matrices.to(device=batch.device, dtype=torch.float32)
    yy, xx = torch.meshgrid(torch.arange(h, dtype=torch.float32, device=batch.device),
                            torch.arange(w, dtype=torch.float32, device=batch.device),
                            indexing="ij")
    m = m[:, :, :, None, None]
    sy = m[:, 0, 0] * yy + m[:, 0, 1] * xx + m[:, 0, 2]
    sx = m[:, 1, 0] * yy + m[:, 1, 1] * xx + m[:, 1, 2]
    grid = torch.stack([sx * (2.0 / (w - 1)) - 1.0, sy * (2.0 / (h - 1)) - 1.0], dim=-1)
    out = F.grid_sample(batch.permute(0, 3, 1, 2).float(), grid, mode="bilinear",
                        padding_mode="zeros", align_corners=True)
    return out.permute(0, 2, 3, 1).contiguous()


def flip(batch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Each NHWC image flipped left to right where `mask` [b] is True."""
    mask = mask.to(device=batch.device, dtype=torch.bool)
    return torch.where(mask[:, None, None, None], batch.flip(2), batch)


class MnistAugment:
    """RandomRotation(degrees) + RandomResizedCrop((H, W), scale, ratio)
    (JAX `make_mnist_augment`, dataset.py:475-479). `augment(batch,
    generator)` draws and applies; `draw` and `apply` apart take or give
    the draws."""

    def __init__(self, degrees=20.0, scale=(0.9, 1.0), ratio=(0.9, 1.1)):
        self.degrees, self.scale, self.ratio = degrees, tuple(scale), tuple(ratio)

    def draw(self, generator: torch.Generator, b: int) -> torch.Tensor:
        """[b, 5] on the CPU: uniforms in [-degrees, degrees], scale,
        [log ratio[0], log ratio[1]], [0, 1] and [0, 1]."""
        lo = torch.tensor([-self.degrees, self.scale[0], math.log(self.ratio[0]), 0.0, 0.0])
        hi = torch.tensor([self.degrees, self.scale[1], math.log(self.ratio[1]), 1.0, 1.0])
        return torch.rand(b, 5, generator=generator) * (hi - lo) + lo

    def apply(self, batch: torch.Tensor, draws: torch.Tensor) -> torch.Tensor:
        _, h, w, _ = batch.shape
        return affine_warp(batch, rotation_crop_matrices(draws, h, w))

    def __call__(self, batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(batch, self.draw(generator, batch.shape[0]))


class FlipAugment:
    """Random horizontal flip with probability 1/2 (JAX
    `make_flip_augment`); the draws are a boolean mask [b]."""

    def draw(self, generator: torch.Generator, b: int) -> torch.Tensor:
        return torch.rand(b, generator=generator) < 0.5

    def apply(self, batch: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return flip(batch, mask)

    def __call__(self, batch: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        return self.apply(batch, self.draw(generator, batch.shape[0]))


def make_mnist_augment(degrees=20.0, scale=(0.9, 1.0), ratio=(0.9, 1.1)) -> MnistAugment:
    return MnistAugment(degrees, scale, ratio)


def make_flip_augment() -> FlipAugment:
    return FlipAugment()


AUGMENTATIONS = {
    "mnist": make_mnist_augment,
    "cifar10": make_flip_augment,
    "celeba": make_flip_augment,
}


def load_image_dataset(name: str, fake: bool = False, seed: int = 0):
    """((xtr, ytr), (xte, yte)), NHWC float32 in [0, 1]."""
    if fake:
        return fake_image_dataset(name, seed=seed)
    if name in ("mnist", "fashionmnist"):
        return load_idx_dataset(name)
    if name == "cifar10":
        return load_cifar10()
    if name in ("celeba", "omniglot"):
        return load_image_folder(name)
    raise FileNotFoundError(
        f"Image dataset '{name}' requires local files (no egress); "
        f"pass fake=True for synthetic stand-ins."
    )
