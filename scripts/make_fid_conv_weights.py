#!/usr/bin/env python
"""Write the random-conv FID extractor's seed-0 weights for the PyTorch port.

The JAX package draws the extractor's weights from jax.random.PRNGKey(seed)
(vae_song_tpu/ops/fid.py:make_conv_feature_extractor); torch cannot draw
the same numbers, so the port carries them. This script repeats JAX's
draws for 1 and 3 input channels and writes them, HWIO, to
vae_song_tpu_torch/ops/fid_conv_seed0.npz with the keys c{C}_conv{i} and
c{C}_proj. Needs jax.

Usage:
  python scripts/make_fid_conv_weights.py [--out PATH]
"""

import argparse
import os

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def draw(channels: int, seed: int = 0, feature_dim: int = 64):
    """JAX make_conv_feature_extractor's weights: ([HWIO convs], proj)."""
    import jax

    chans = [channels, 8, 16, 32]
    keys = jax.random.split(jax.random.PRNGKey(seed), len(chans))
    convs = [
        np.asarray(jax.random.normal(keys[i], (3, 3, chans[i], chans[i + 1]))
                   * np.sqrt(2.0 / (9 * chans[i]), dtype=np.float32))
        for i in range(len(chans) - 1)
    ]
    proj = np.asarray(jax.random.normal(keys[-1], (chans[-1], feature_dim))
                      * np.sqrt(1.0 / chans[-1], dtype=np.float32))
    return convs, proj


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(ROOT, "vae_song_tpu_torch", "ops",
                                                  "fid_conv_seed0.npz"))
    args = ap.parse_args()
    arrays = {}
    for c in (1, 3):
        convs, proj = draw(c)
        arrays.update({f"c{c}_conv{i}": w for i, w in enumerate(convs)})
        arrays[f"c{c}_proj"] = proj
    np.savez(args.out, **arrays)
    print(f"wrote {args.out}: {sorted(arrays)}")


if __name__ == "__main__":
    main()
