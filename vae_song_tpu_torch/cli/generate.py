"""Sample generation from a trained checkpoint (port of
vae_song_tpu/cli/generate.py, the reference's test.py): checkpoint ->
z ~ N(0, I) -> decode -> .npy/.ply point clouds for the set models, PNG
grids of 16 images (4 a row) for the image models, or one 2-D histogram
for the 1-D datasets' models.

Usage:
    python -m vae_song_tpu_torch.cli.generate --config configs/config_mnist.yaml \
        --param_dir results/.../params/model_99.pkl --n_samples 100

The checkpoint is the JAX trainer's `params/model_{epoch}.pkl`, written
by either package. The device defaults to CUDA; `--device cpu` runs the
plain PyTorch versions of the kernels on the CPU. The PNGs need
matplotlib; without it the run names the files it did not write.
`--quant int8` decodes from int8 weights and activations
(serving/quant.py), for every family.
"""

import argparse
import os

import numpy as np
import torch

from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.serving.quant import make_quantized_decode, quantize_dense_params
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train.steps import make_apply_fns
from vae_song_tpu_torch.viz.plots import plot_2d_histogram, save_image_grid, save_point_cloud


def create_model_from_config(config):
    """Model for the first sweep point of a config dict (test.py:33-100)."""
    mp = config["model_params"]
    return build_model(
        config["experiment_type"], config["common_params"].get("exp_data", "mnist"), mp,
        beta=mp.get("beta_list", [1.0])[0], alpha=mp.get("alpha_list", [0.01])[0],
        il=mp.get("il_list", [0.0])[0],
    )


def generate_samples(model, n_samples, batch_size=32, seed=0, z=None, quant=None):
    """Batched z ~ N(0, I) -> decode on the model's device (test.py:113-140),
    one full batch at a time, cut to `n_samples`. z: the noise of every
    batch, [ceil(n_samples / batch_size), batch_size, latent] (JAX draws
    it from its PRNG); None draws it on the CPU from a torch.Generator
    seeded with `seed`, so the samples do not depend on the device.
    quant="int8" decodes with the dense layers served from int8
    (serving/quant.py). Returns float32 numpy [n_samples, ...]."""
    if quant == "int8":
        decode = make_quantized_decode(model, quantize_dense_params(model))
    elif quant in (None, "none"):
        _, decode, _ = make_apply_fns(model)
    else:
        raise ValueError(f"unknown quant mode {quant!r}")
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    samples = []
    for k, i in enumerate(range(0, n_samples, batch_size)):
        bs = min(batch_size, n_samples - i)
        zb = (torch.randn(batch_size, model.latent_channel, generator=gen) if z is None
              else torch.as_tensor(z[k]))
        samples.append(decode(zb.to(device)).float().cpu().numpy()[:bs])
    return np.concatenate(samples, axis=0)


def main(argv=None):
    parser = argparse.ArgumentParser(description="Generate samples from a trained model")
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--param_dir", type=str, required=True,
                        help="path to a .pkl params checkpoint")
    parser.add_argument("--n_samples", type=int, default=100)
    parser.add_argument("--batch_size", type=int, default=32)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default="cuda", choices=["cpu", "cuda"])
    parser.add_argument("--quant", type=str, default="none", choices=["none", "int8"],
                        help="serve the dense layers from int8 weights (serving/quant.py)")
    args = parser.parse_args(argv)

    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    model = create_model_from_config(config)
    if not os.path.exists(args.param_dir):
        raise FileNotFoundError(f"Checkpoint file not found: {args.param_dir}")
    ckpt_lib.load_params_only(args.param_dir, model)
    model.to(args.device)

    print(f"Loaded model from: {args.param_dir}")
    print(f"Model type: {type(model).__name__}")
    print(f"Generating {args.n_samples} samples...")

    output_dir = os.path.join(os.path.dirname(args.param_dir), "gen_samples")
    os.makedirs(output_dir, exist_ok=True)
    samples = generate_samples(model, args.n_samples, args.batch_size, args.seed,
                               quant=args.quant)
    if getattr(model, "data_type", None) == "set":
        print(f"Saving point cloud samples to: {output_dir}")
        for i, points in enumerate(samples):
            save_point_cloud(points, os.path.join(output_dir, f"sample_{i:04d}"))
    elif samples.ndim == 2:
        print(f"Saving a histogram of the samples to: {output_dir}")
        path = os.path.join(output_dir, "samples_hist.png")
        try:
            plot_2d_histogram(samples, filepath=path)
        except ImportError as e:
            print(f"{path} not written: {e!r}")
    else:
        print(f"Saving image samples to: {output_dir}")
        paths = [os.path.join(output_dir, f"samples_{i // 16:04d}.png")
                 for i in range(0, len(samples), 16)]
        try:
            for i, path in zip(range(0, len(samples), 16), paths):
                save_image_grid(np.clip(samples[i:i + 16], 0, 1), path, nrow=4)
        except ImportError as e:
            print(f"{len(paths)} image grids not written: {e!r}")
    print(f"Generation complete! Samples saved to: {output_dir}")
    return output_dir


if __name__ == "__main__":
    main()
