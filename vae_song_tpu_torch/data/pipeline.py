"""Host-side batching (port of vae_song_tpu/data/pipeline.py, its numpy
part; the JAX file imports jax, so it is copied, not imported).

Data lives in host numpy arrays. Batches are the JAX pipeline's: the
indices 0..n-1, shuffled in place by the caller's numpy Generator when
`shuffle` is set, cut into full batches (drop_last), each copied to the
device as a torch tensor.
"""

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class ArrayDataset:
    """In-memory dataset: X [N, ...], y [N]."""

    X: np.ndarray
    y: np.ndarray

    def __len__(self):
        return len(self.X)


def iterate_batches(dataset: ArrayDataset, batch_size: int,
                    rng: np.random.Generator | None = None, shuffle: bool = True,
                    drop_last: bool = True, device=None):
    """Yield (x, y) torch tensors on `device` (the CPU when None)."""
    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for i in range(num_batches(dataset, batch_size, drop_last)):
        sel = idx[i * batch_size:(i + 1) * batch_size]
        yield (torch.from_numpy(dataset.X[sel]).to(device),
               torch.from_numpy(dataset.y[sel]).to(device))


def num_batches(dataset, batch_size, drop_last=True):
    n = len(dataset)
    return n // batch_size if drop_last else -(-n // batch_size)
