"""Sample generation from a trained checkpoint (port of
vae_song_tpu/cli/generate.py for the set models; the other families
raise, naming their ROADMAP.md item): checkpoint -> z ~ N(0, I) ->
decode -> .npy/.ply point clouds.

Usage:
    python -m vae_song_tpu_torch.cli.generate \
        --config configs/config_shapenet_setvae.yaml \
        --param_dir results/.../params/model_99.pkl --n_samples 100

The checkpoint is the JAX trainer's `params/model_{epoch}.pkl`. The
device defaults to CUDA; `--device cpu` runs the plain PyTorch versions
of the kernels on the CPU.
"""

import argparse
import os

import numpy as np
import torch

from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train.steps import make_apply_fns
from vae_song_tpu_torch.viz.plots import save_point_cloud


def create_model_from_config(config):
    """Model for the first sweep point of a config dict."""
    mp = config["model_params"]
    return build_model(
        config["experiment_type"], config["common_params"].get("exp_data", "mnist"), mp,
        beta=mp.get("beta_list", [1.0])[0], alpha=mp.get("alpha_list", [0.01])[0],
    )


def generate_samples(model, n_samples, batch_size=32, seed=0):
    """Batched z ~ N(0, I) -> decode, on the model's device. z is drawn on
    the CPU from a torch.Generator seeded with `seed`, one full batch at a
    time, so the samples do not depend on the device. Returns a float32
    numpy array [n_samples, num_points, 3]."""
    _, decode, _ = make_apply_fns(model)
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    samples = []
    for i in range(0, n_samples, batch_size):
        bs = min(batch_size, n_samples - i)
        z = torch.randn(batch_size, model.latent_channel, generator=gen).to(device)
        samples.append(decode(z)[:bs].float().cpu().numpy())
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
    args = parser.parse_args(argv)

    import yaml

    with open(args.config) as f:
        config = yaml.safe_load(f)
    model = create_model_from_config(config)
    if getattr(model, "data_type", None) != "set":
        raise NotImplementedError(
            f"generation for {type(model).__name__} is not ported yet; see ROADMAP.md "
            "Queue 1 item 13 (FID and generation)"
        )
    if not os.path.exists(args.param_dir):
        raise FileNotFoundError(f"Checkpoint file not found: {args.param_dir}")
    ckpt_lib.load_params_only(args.param_dir, model)
    model.to(args.device)

    print(f"Loaded model from: {args.param_dir}")
    print(f"Model type: {type(model).__name__}")
    print(f"Generating {args.n_samples} samples...")

    output_dir = os.path.join(os.path.dirname(args.param_dir), "gen_samples")
    os.makedirs(output_dir, exist_ok=True)
    samples = generate_samples(model, args.n_samples, args.batch_size, args.seed)
    print(f"Saving point cloud samples to: {output_dir}")
    for i, points in enumerate(samples):
        save_point_cloud(points, os.path.join(output_dir, f"sample_{i:04d}"))
    print(f"Generation complete! Samples saved to: {output_dir}")
    return output_dir


if __name__ == "__main__":
    main()
