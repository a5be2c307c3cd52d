"""Lipschitz / KL sweep runner (port of vae_song_tpu/parallel/sweep.py;
the reference's exp_lip_lrvae.sh / exp_lip_illidvae.sh): every (beta,
alpha or IL, seed) point through cli/lipschitz.main, in one process, one
after the other on one device.

    python -m vae_song_tpu_torch.parallel.sweep --model lrvae \\
        --alphas 0.0 0.1 --betas 0.1 --seeds 42 --epochs 1000 \\
        --output_root results/ablation_lrvae_linear [--device cpu]

Each point writes under <output_root>/<reg>_<value>_beta_<beta>_seed_<seed>/
and appends its row to <output_root>/exp_lip.csv. A point that raises is
recorded with ok False and its error, and the sweep goes on, as the
per-process scripts did.
"""

import argparse
import itertools
import os
import time


def run_sweep(model="lrvae", alphas=(0.0,), ils=(0.0,), betas=(1.0,), seeds=(42,), epochs=1000,
              output_root="results/ablation", extra_args=(), device="cuda"):
    """Returns one dict a point: the CLI's metrics, the point's settings,
    wall_sec and ok (or ok False and error)."""
    from vae_song_tpu_torch.cli import lipschitz as lip_cli

    reg_values = ils if model == "lidvae" else alphas
    reg_flag = "--IL" if model == "lidvae" else "--alpha"
    reg_name = "IL" if model == "lidvae" else "alpha"

    results = []
    for beta, reg, seed in itertools.product(betas, reg_values, seeds):
        outdir = os.path.join(output_root, f"{reg_name}_{reg}_beta_{beta}_seed_{seed}")
        argv = [
            "--model", model,
            "--epochs", str(epochs),
            reg_flag, str(reg),
            "--beta", str(beta),
            "--K", "16", "--K_z", "16",
            "--z_min", "-3", "--z_max", "3",
            "--output_dir", outdir,
            "--seed", str(seed),
            "--wu_strat", "linear",
            "--wu_start_epoch", "0",
            "--device", str(device),
        ] + list(extra_args)
        t0 = time.time()
        print(f"=== sweep point: {reg_name}={reg} beta={beta} seed={seed} ===", flush=True)
        try:
            metrics = lip_cli.main(argv)
            metrics.update({reg_name: reg, "beta": beta, "seed": seed,
                            "wall_sec": time.time() - t0, "ok": True})
        except Exception as e:  # keep sweeping, as the per-process scripts did
            print(f"sweep point failed: {e!r}", flush=True)
            metrics = {reg_name: reg, "beta": beta, "seed": seed,
                       "wall_sec": time.time() - t0, "ok": False, "error": repr(e)}
        results.append(metrics)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="Lipschitz/KL sweep runner")
    parser.add_argument("--model", type=str, default="lrvae", choices=["lrvae", "lidvae"])
    parser.add_argument("--alphas", nargs="+", type=float, default=[0.0, 0.1, 0.2, 0.3, 0.4])
    parser.add_argument("--ils", nargs="+", type=float, default=[0.0, 0.1, 0.2, 0.3, 0.4])
    parser.add_argument("--betas", nargs="+", type=float, default=[0.7, 0.8, 0.9, 1.0])
    parser.add_argument("--seeds", nargs="+", type=int, default=[42, 43, 44, 45])
    parser.add_argument("--epochs", type=int, default=1000)
    parser.add_argument("--output_root", type=str, default="results/ablation_lrvae_linear")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    return run_sweep(args.model, tuple(args.alphas), tuple(args.ils), tuple(args.betas),
                     tuple(args.seeds), args.epochs, args.output_root, device=args.device)


if __name__ == "__main__":
    main()
