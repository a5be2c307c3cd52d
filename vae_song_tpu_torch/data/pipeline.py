"""Host-side batching (port of vae_song_tpu/data/pipeline.py; the JAX file
imports jax, so it is copied, not imported).

Data lives in host numpy arrays. Batches are the JAX pipeline's: the
indices 0..n-1, shuffled in place by the caller's numpy Generator when
`shuffle` is set, cut into full batches (drop_last), each copied to the
device as a torch tensor; or, with `native_prefetch`, assembled by the
native loader's C++ worker threads (data/native.py:NativeBatchLoader),
seeded from the caller's Generator as JAX seeds it. An augment applies to
each batch on the device.
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
                    drop_last: bool = True, device=None, augment=None,
                    augment_rng: torch.Generator | None = None,
                    native_prefetch: bool = False):
    """Yield (x, y) torch tensors on `device` (the CPU when None).

    augment: a data.images augment, `augment(x, augment_rng)` applied to
    each batch on the device, its draws taken from `augment_rng` batch
    after batch.
    native_prefetch: with drop_last, the batches come from
    NativeBatchLoader, seeded with `rng.integers(2**63)` (JAX's seed);
    its shuffle is the library's, not `rng`'s, so the batch order differs
    from the numpy path's. Without the library it takes the numpy path,
    as in JAX."""
    if native_prefetch and drop_last:
        from vae_song_tpu_torch.data import native

        if native.available():
            seed = int((rng or np.random.default_rng()).integers(2**63))
            loader = native.NativeBatchLoader(dataset.X, dataset.y, batch_size,
                                              shuffle=shuffle, seed=seed)
            for hx, hy in loader:
                yield _to_device(hx, hy, device, augment, augment_rng)
            return

    n = len(dataset)
    idx = np.arange(n)
    if shuffle:
        (rng or np.random.default_rng()).shuffle(idx)
    for i in range(num_batches(dataset, batch_size, drop_last)):
        sel = idx[i * batch_size:(i + 1) * batch_size]
        yield _to_device(dataset.X[sel], dataset.y[sel], device, augment, augment_rng)


def _to_device(hx, hy, device, augment, augment_rng):
    x = torch.from_numpy(hx).to(device)
    if augment is not None:
        x = augment(x, augment_rng)
    return x, torch.from_numpy(hy).to(device)


def num_batches(dataset, batch_size, drop_last=True):
    n = len(dataset)
    return n // batch_size if drop_last else -(-n // batch_size)
