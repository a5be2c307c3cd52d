"""Complexity benchmark CLI (port of vae_song_tpu/cli/complexity.py, the
reference's complexity_benchmark.py): wall clock and memory of training
and evaluating VanillaVAE, LIDVAE and LRVAE on MNIST, written as
`complexity_results.csv` with the JAX package's columns in its order.

Usage:
    python -m vae_song_tpu_torch.cli.complexity --epochs 5 --fake_data

Each model trains with its own gradient mode (the JAX package's fix of
the reference, whose staged backward fails for VanillaVAE and LIDVAE).
`--fake_data` takes the seeded stand-in images; without it the MNIST IDX
files must be under $VST_DATA_ROOT (nothing is downloaded). Times are the
host clock, each phase closed by a scalar fetch, the first train and
eval calls made before the timed phases on a copy of the model. Memory:
the process's peak resident set (`ru_maxrss`, MB) and the device's
allocated memory (train/profiling.py:device_memory_mb; 0.0 on the CPU),
the latter under the JAX package's column names `*_gpu_memory_mb`. The
sample grids need matplotlib; without it the run names the grids it did
not write.
"""

import argparse
import copy
import csv
import os
import resource
import time
from datetime import datetime

import numpy as np
import torch

from vae_song_tpu_torch import data as data_lib
from vae_song_tpu_torch.data.pipeline import iterate_batches
from vae_song_tpu_torch.models.flexible import LRVAE, VanillaVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train.loggers import count_params
from vae_song_tpu_torch.train.profiling import device_memory_mb
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step, make_train_step
from vae_song_tpu_torch.viz.plots import save_image_grid


def get_memory_usage_mb():
    """The process's peak resident set size in MB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024.0


def train_one_model(model, train_ds, test_ds, augment, epochs, batch_size, num_mc_samples=1,
                    grad_clip=None, seed=42, eval_trials=1, device="cuda"):
    """Train `model` for `epochs` on `device` and time its eval over the
    test split (the best of `eval_trials`); returns (model, metrics) with
    JAX's keys. The noise and the augment's draws come from CPU
    torch.Generators seeded from `seed`. LIDVAE takes one latent sample a
    step whatever `num_mc_samples` says, as in JAX."""
    device = torch.device(device)
    model.to(device)
    np_rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    steps_per_epoch = len(train_ds) // batch_size
    # max(1, ...): epochs=0 must not give the cosine schedule a 0-step horizon
    optimizer = make_optimizer(model.parameters(), lr=1e-2,
                               total_steps=max(1, epochs * steps_per_epoch), grad_clip=grad_clip)
    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)
    latent = model.latent_channel
    num_mc_samples = 1 if isinstance(model, LIDVAE) else num_mc_samples

    def eps(b, samples=num_mc_samples):
        return torch.randn(samples, b, latent, generator=gen).to(device)

    # the first calls outside the timed phases, the train step's on a copy
    # (it updates its model), as the JAX benchmark warms its compiled steps
    x0 = next(iter(iterate_batches(train_ds, batch_size, rng=np.random.default_rng(seed),
                                   device=device, augment=augment,
                                   augment_rng=torch.Generator().manual_seed(seed))))[0]
    warm = copy.deepcopy(model)
    warm_m = make_train_step(warm, make_optimizer(warm.parameters(), lr=1e-2))(x0, eps(len(x0)),
                                                                              1.0)
    float(warm_m["loss"])
    del warm
    xt0 = torch.from_numpy(test_ds.X[:batch_size]).to(device)
    float(eval_step(xt0, eps(len(xt0), 1), 1.0)["loss"])

    mem0 = get_memory_usage_mb()
    t0 = time.time()
    m = warm_m  # epochs=0: no timed steps
    augment_rng = torch.Generator().manual_seed(seed + 1)
    for _epoch in range(epochs):
        for x, _y in iterate_batches(train_ds, batch_size, rng=np_rng, device=device,
                                     augment=augment, augment_rng=augment_rng):
            m = train_step(x, eps(len(x)), 1.0)
    float(m["loss"])
    train_time = time.time() - t0
    train_mem = max(0.0, get_memory_usage_mb() - mem0)
    train_dev = device_memory_mb(device)

    mem0 = get_memory_usage_mb()
    eval_time, totals, n = float("inf"), None, 0
    for _trial in range(max(1, eval_trials)):
        t1 = time.time()
        ms = [eval_step(x, eps(len(x), 1), 1.0)
              for x, _y in iterate_batches(test_ds, batch_size, rng=np_rng, shuffle=False,
                                           device=device)]
        n = len(ms)
        totals = ({k: float(sum(float(mm[k]) for mm in ms)) for k in ms[0]} if ms
                  else {"loss": 0.0, "recon": 0.0, "reg": 0.0, "lr": 0.0})
        eval_time = min(eval_time, time.time() - t1)
    eval_mem = max(0.0, get_memory_usage_mb() - mem0)
    eval_dev = device_memory_mb(device)
    return model, {
        "train_time_sec": train_time,
        "eval_time_sec": eval_time,
        "train_memory_mb": train_mem,
        "eval_memory_mb": eval_mem,
        "train_gpu_memory_mb": train_dev,
        "eval_gpu_memory_mb": eval_dev,
        "eval_losses": tuple(v / max(n, 1) for v in totals.values()),
    }


def sample_and_save_grids(model, output_dir, model_name, num_grids=4, grid_n=8, seed=0):
    """`num_grids` grids of grid_n x grid_n images decoded from z ~ N(0, I)
    (a CPU torch.Generator seeded with `seed`) into `output_dir`."""
    os.makedirs(output_dir, exist_ok=True)
    _, decode_fn, _ = make_apply_fns(model)
    device = next(model.parameters()).device
    gen = torch.Generator().manual_seed(seed)
    paths = [os.path.join(output_dir, f"{model_name}_samples_grid_{i + 1}.png")
             for i in range(num_grids)]
    for path in paths:
        z = torch.randn(grid_n * grid_n, model.latent_channel, generator=gen).to(device)
        x = decode_fn(z).float().cpu().numpy()
        if x.ndim == 2:
            side = int(round(x.shape[1] ** 0.5))
            x = x.reshape(-1, side, side, 1)
        try:
            save_image_grid(np.clip(x, 0.0, 1.0), path, nrow=grid_n, normalize=False)
        except ImportError as e:
            print(f"{model_name}: sample grids {paths} not written: {e!r}")
            return


def main(argv=None):
    parser = argparse.ArgumentParser(description="Complexity benchmark on MNIST "
                                                 "(vae_song_tpu_torch)")
    parser.add_argument("--output_dir", type=str, default="results/complexity_benchmark")
    parser.add_argument("--epochs", type=int, default=5)
    parser.add_argument("--batch_size", type=int, default=128)
    parser.add_argument("--num_mc_samples", type=int, default=1)
    parser.add_argument("--alpha", type=float, default=0.1)
    parser.add_argument("--beta", type=float, default=1.0)
    parser.add_argument("--inverse_lipschitz", type=float, default=0.0)
    parser.add_argument("--fake_data", action="store_true")
    parser.add_argument("--eval_trials", type=int, default=1,
                        help="best-of-N eval wall clock")
    parser.add_argument("--grad_clip_enabled", action="store_true")
    parser.add_argument("--grad_clip_type", type=str, default="norm", choices=["norm", "value"])
    parser.add_argument("--grad_clip_max_norm", type=float, default=1.0)
    parser.add_argument("--grad_clip_norm_type", type=float, default=2.0,
                        help="p-norm for norm clipping (reference complexity_benchmark.py:171)")
    parser.add_argument("--grad_clip_value", type=float, default=1.0)
    parser.add_argument("--seed", type=int, default=0, help="the models' weights")
    parser.add_argument("--device", type=str, default="cuda", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    train_ds, test_ds, augment = data_lib.load_dataset("mnist", fake=args.fake_data, seed=0)
    grad_clip = {
        "enabled": args.grad_clip_enabled,
        "clip_type": args.grad_clip_type,
        "max_norm": args.grad_clip_max_norm,
        "norm_type": args.grad_clip_norm_type,
        "clip_value": args.grad_clip_value,
    }
    gen = torch.Generator().manual_seed(args.seed)
    models_to_test = [
        ("VanillaVAE", lambda: VanillaVAE.for_dataset(
            "mnist", beta=args.beta, encoder_type="conv", decoder_type="mlp", generator=gen)),
        ("LIDVAE", lambda: LIDVAE.for_dataset(
            "mnist", inverse_lipschitz=args.inverse_lipschitz, beta=args.beta, generator=gen)),
        ("LRVAE", lambda: LRVAE.for_dataset(
            "mnist", beta=args.beta, alpha=args.alpha, encoder_type="conv",
            decoder_type="mlp", generator=gen)),
    ]

    results = []
    for model_name, factory in models_to_test:
        print(f"\n=== Testing {model_name} on MNIST ===", flush=True)
        model, metrics = train_one_model(
            factory(), train_ds, test_ds, augment, args.epochs, args.batch_size,
            args.num_mc_samples, grad_clip, eval_trials=args.eval_trials, device=args.device,
        )
        n_params = count_params(model)
        model_size_mb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1024.0**2
        ckpt_lib.save_params_only(os.path.join(args.output_dir, "weights", f"{model_name}.pkl"),
                                  model)
        sample_and_save_grids(model, os.path.join(args.output_dir, "samples"), model_name)
        results.append({
            "model": model_name,
            "parameters": n_params,
            "model_size_mb": model_size_mb,
            "train_time_sec": metrics["train_time_sec"],
            "eval_time_sec": metrics["eval_time_sec"],
            "train_memory_mb": metrics["train_memory_mb"],
            "eval_memory_mb": metrics["eval_memory_mb"],
            "train_gpu_memory_mb": metrics["train_gpu_memory_mb"],
            "eval_gpu_memory_mb": metrics["eval_gpu_memory_mb"],
            "alpha": args.alpha if model_name == "LRVAE" else None,
            "beta": args.beta,
            "inverse_lipschitz": args.inverse_lipschitz if model_name == "LIDVAE" else None,
        })
        print(f"{model_name}: {n_params:,} params, train {metrics['train_time_sec']:.1f}s, "
              f"eval {metrics['eval_time_sec']:.1f}s")

    csv_path = os.path.join(args.output_dir, "complexity_results.csv")
    with open(csv_path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(results[0].keys()))
        w.writeheader()
        w.writerows(results)

    timestamp = datetime.now().strftime("%Y%m%d_%H%M%S")
    log_file = os.path.join(args.output_dir, f"complexity_benchmark_log_{timestamp}.txt")
    with open(log_file, "w") as f:
        f.write(f"Complexity Benchmark Results - {datetime.now():%Y-%m-%d %H:%M:%S}\n")
        f.write("=" * 80 + "\n")
        for r in results:
            f.write(str(r) + "\n")

    print(f"\nBenchmark complete. Results saved to {args.output_dir}")
    print(f"CSV: {csv_path}")
    return results


if __name__ == "__main__":
    main()
