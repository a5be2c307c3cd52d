"""Frechet Inception Distance (port of vae_song_tpu/ops/fid.py): the metric
in numpy/scipy, the feature extractors as torch modules on an explicit
device.

    FID = ||mu1 - mu2||^2 + Tr(C1 + C2 - 2 (C1 C2)^{1/2})

Extractor selection (`default_extractor`):
  * $VST_FID_WEIGHTS=<path> (or an explicit weights_path): the InceptionV3
    pool3 graph (ops/inception.py) on those torchvision-named weights;
    scores are then comparable to published pytorch_fid numbers;
  * otherwise the seeded random-conv embedding: scores are comparable
    between runs of either package (the same weights) but not to
    Inception-FID.

The random-conv weights are JAX's: drawn there from `PRNGKey(seed)`, which
torch cannot reproduce, so the port carries them for the one seed the
trainers use, 0, in `fid_conv_seed0.npz` beside this file (written by
scripts/make_fid_conv_weights.py), for 1 and 3 input channels.
"""

import os

import numpy as np
import torch
import torch.nn.functional as F
from scipy import linalg

from vae_song_tpu_torch.nn.blocks import _ieee_f32

CONV_WEIGHTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fid_conv_seed0.npz")
CONV_CHANNELS = (8, 16, 32)
CONV_FEATURES = 64


def gaussian_stats(features):
    features = np.asarray(features, np.float64)
    mu = features.mean(axis=0)
    sigma = np.cov(features, rowvar=False)
    return mu, np.atleast_2d(sigma)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Frechet distance between two Gaussians (the standard FID formula).
    `sqrtm` without JAX's `disp=False`, which SciPy 1.18 removed: the same
    matrix either way."""
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean))


def fid_from_features(feats_real, feats_fake) -> float:
    mu1, s1 = gaussian_stats(feats_real)
    mu2, s2 = gaussian_stats(feats_fake)
    return frechet_distance(mu1, s1, mu2, s2)


def extract(extractor, batch) -> np.ndarray:
    """extractor's features [B, D] of one image batch (numpy or tensor,
    NHWC or NHW) as numpy: an extractor module gets the batch on its
    device; any other callable gets it as it is."""
    if isinstance(extractor, torch.nn.Module):
        batch = torch.as_tensor(batch).to(next(extractor.buffers()).device)
    with torch.no_grad():
        out = extractor(batch)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)


def fid_score(extractor, real_batches, fake_batches) -> float:
    """FID of two iterables of image batches; extractor(batch) -> [B, D]."""
    fr = np.concatenate([extract(extractor, b) for b in real_batches])
    ff = np.concatenate([extract(extractor, b) for b in fake_batches])
    return fid_from_features(fr, ff)


def default_extractor(image_shape, seed: int = 0, weights_path: str | None = None,
                      device="cuda"):
    """(extractor module on `device`, is_inception): InceptionV3 pool3 when
    weights are given (explicit path or $VST_FID_WEIGHTS), else the seeded
    random-conv embedding."""
    path = weights_path or os.environ.get("VST_FID_WEIGHTS")
    if path:
        if not os.path.exists(path):
            raise FileNotFoundError(f"VST_FID_WEIGHTS points to a missing file: {path}")
        from vae_song_tpu_torch.ops.inception import InceptionV3Features

        return InceptionV3Features(path, device=device), True
    return make_conv_feature_extractor(image_shape, seed=seed, device=device), False


def _same_pad(n: int, k: int = 3, stride: int = 2):
    """XLA's "SAME" padding (low, high) of one axis of length n."""
    total = max((-(-n // stride) - 1) * stride + k - n, 0)
    return total // 2, total - total // 2


class RandomConvFeatures(torch.nn.Module):
    """The untrained seeded CNN of JAX `make_conv_feature_extractor`: three
    3 x 3 stride-2 "SAME" convolutions without bias, each followed by
    LeakyReLU(0.2), the global mean pool and a linear projection to 64
    features. Not InceptionV3: a FID proxy for boxes without its weights.
    Takes NHWC (or NHW) images, gives [B, 64] float32; on the card the
    convolutions run in IEEE f32 (cuDNN TF32 off)."""

    def __init__(self, convs, proj):
        super().__init__()
        for i, w in enumerate(convs):   # HWIO -> OIHW
            self.register_buffer(f"conv{i}", torch.from_numpy(
                np.ascontiguousarray(np.transpose(w, (3, 2, 0, 1)))))
        self.register_buffer("proj", torch.from_numpy(np.asarray(proj)))
        self.n_convs = len(convs)

    def forward(self, x):
        h = x.to(torch.float32)
        if h.dim() == 3:
            h = h[..., None]
        h = h.permute(0, 3, 1, 2)
        with _ieee_f32(h):
            for i in range(self.n_convs):
                (t, b), (left, right) = _same_pad(h.shape[2]), _same_pad(h.shape[3])
                h = F.conv2d(F.pad(h, (left, right, t, b)), getattr(self, f"conv{i}"), stride=2)
                h = F.leaky_relu(h, 0.2)
        return h.mean(dim=(2, 3)) @ self.proj


def load_conv_weights(channels: int):
    """(HWIO conv weights, projection) of the seed-0 random-conv extractor
    for `channels` input channels, from CONV_WEIGHTS (numpy alone)."""
    with np.load(CONV_WEIGHTS) as z:
        if f"c{channels}_proj" not in z.files:
            raise ValueError(f"the random-conv FID weights cover 1 and 3 input channels, "
                             f"not {channels}")
        convs = [z[f"c{channels}_conv{i}"] for i in range(len(CONV_CHANNELS))]
        return convs, z[f"c{channels}_proj"]


def make_conv_feature_extractor(image_shape, seed: int = 0, feature_dim: int = CONV_FEATURES,
                                device="cuda"):
    """The seeded random-conv embedding for (H, W, C) images on `device`.
    Seed 0 only: its weights come from JAX's PRNG, which torch cannot draw,
    and the port carries seed 0's, the one seed the JAX trainer uses."""
    if seed != 0 or feature_dim != CONV_FEATURES:
        raise ValueError(
            f"the port carries JAX's random-conv FID weights for seed 0 and "
            f"{CONV_FEATURES} features only (drawn from jax.random.PRNGKey(0), which torch "
            f"cannot reproduce); got seed={seed}, feature_dim={feature_dim}")
    convs, proj = load_conv_weights(image_shape[-1] if len(image_shape) == 3 else 1)
    return RandomConvFeatures(convs, proj).to(device)
