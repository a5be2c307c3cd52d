"""Train, then measure the Lipschitz / KL fields (port of
vae_song_tpu/cli/lipschitz.py, the reference's lipschitz.py, the paper's
entry point):

    python -m vae_song_tpu_torch.cli.lipschitz --model lidvae --IL 0.1 --beta 0.5 \\
        --output_dir results/ablation/run [--device cpu]

Pipeline (lipschitz.py:225-556), with the JAX CLI's flags and defaults:
  1. SimpleGaussianMixture training data (and its 2-D histogram);
  2. train LRVAE (warmup alpha from 1.0, composite gradient) or LIDVAE
     with train/scan.py (Adam, no scheduler);
  3. X-space per-cell KL and decoder Lipschitz fields on a K x K spatial
     grid over the data's bounding box;
  4. Z-space grid fields (decode -> re-encode KL, decoder Lipschitz);
  5. the data-based global KL and L(z);
  6. 8 heatmap PNGs, experiment_metrics.csv (K^2 + K_z^2 rows) and a row
     appended to ../exp_lip.csv; the experiment log.

The device defaults to CUDA. Where matplotlib is not installed the run
prints which PNGs it did not write and goes on; the CSVs and the returned
metrics are always written. The random inputs come from CPU
torch.Generators seeded from --seed (the weights; the training run's
permutations and noise; the analysis draws, `AnalysisDraws`), so a run
does not depend on the device.
"""

import argparse
import csv
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from vae_song_tpu_torch import analysis
from vae_song_tpu_torch.data.synthetic import generate_simple_gaussian_mixture
from vae_song_tpu_torch.models.flexible import LRVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.train.loggers import create_experiment_logger
from vae_song_tpu_torch.train.scan import make_scanned_trainer, precompute_alphas
from vae_song_tpu_torch.train.state import TrainState, make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns
from vae_song_tpu_torch.viz import plots

# the analysis' pair and sample counts (lipschitz.py:400-531)
CELL_PAIRS = 2000
CELL_SAMPLES = 256      # gather_cell_samples' samples a cell
DATA_SAMPLES = 5000
DATA_PAIRS = 5000
Z_GRID_SAMPLES = 100
# random streams of one run, beside the weights' (seeded with --seed)
_TRAIN, _ANALYSIS = 1, 2


def build_argparser():
    p = argparse.ArgumentParser(
        description="Run VAE experiment for local Lipschitz and KL regularization."
    )
    p.add_argument("--alpha", type=float, default=0.1)
    p.add_argument("--IL", type=float, default=0.0)
    p.add_argument("--model", type=str, default="lrvae", choices=["lrvae", "lidvae"])
    p.add_argument("--K", type=int, default=16)
    p.add_argument("--std", type=float, default=0.1)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--beta", type=float, default=1.0)
    p.add_argument("--batch_size", type=int, default=256)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--output_dir", type=str, default="results/ablation")
    p.add_argument("--train_total_samples", type=int, default=10000)
    p.add_argument("--test_total_samples", type=int, default=10000)
    p.add_argument("--distribution_pattern", type=str, default="corner_heavy",
                   choices=["uniform", "corner_heavy", "center_heavy", "sparse_random"])
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--latent_dim", type=int, default=2)
    p.add_argument("--hidden_channels", nargs="+", type=int, default=[64, 128, 64, 2])
    p.add_argument("--num_training_components", type=int, default=8)
    p.add_argument("--K_z", type=int, default=16)
    p.add_argument("--z_min", type=float, default=-3.0)
    p.add_argument("--z_max", type=float, default=3.0)
    p.add_argument("--grad_clip_enabled", action="store_true")
    p.add_argument("--grad_clip_type", type=str, default="norm", choices=["norm", "value"])
    p.add_argument("--grad_clip_max_norm", type=float, default=1.0)
    p.add_argument("--grad_clip_norm_type", type=float, default=2.0)
    p.add_argument("--grad_clip_value", type=float, default=1.0)
    p.add_argument("--wu_strat", type=str, default="linear",
                   choices=["linear", "exponential", "repeat_linear", "kl_adaptive"])
    p.add_argument("--wu_start_epoch", type=int, default=0)
    p.add_argument("--wu_up_amount", type=float, default=None)
    p.add_argument("--wu_repeat_interval", type=int, default=10)
    return p


def _generator(seed: int, stream: int) -> torch.Generator:
    state = np.random.SeedSequence([seed, stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def train_model(model, X, args, grad_clip_cfg, experiment_logger=None, initial_wu_alpha=0.0,
                generator=None):
    """Training of lipschitz.py:23-44: Adam(lr), no scheduler, one composite
    backward a step, the per-epoch warmup alpha (LRVAE); X [N, 2] on the
    model's device. Returns (TrainState, the last epoch's alpha)."""
    optimizer = make_optimizer(model.parameters(), lr=args.lr, total_steps=None,
                               grad_clip=grad_clip_cfg)
    state = TrainState(model, optimizer)
    has_alpha = isinstance(model, LRVAE)
    kl_adaptive = args.wu_strat == "kl_adaptive" and has_alpha
    if has_alpha:
        alphas = precompute_alphas(
            args.epochs, args.wu_strat, up_amount=args.wu_up_amount,
            start_epoch=args.wu_start_epoch, repeat_interval=args.wu_repeat_interval,
            initial_alpha=initial_wu_alpha,
        )
    else:
        alphas = np.zeros(args.epochs, np.float32)
    if experiment_logger and alphas is not None and has_alpha:
        for e in range(args.epochs):
            experiment_logger.log_alpha_value(e, float(alphas[e]))
    fit = make_scanned_trainer(model, optimizer, args.batch_size, args.epochs,
                               grad_mode="composite", kl_adaptive=kl_adaptive)
    state, last = fit(state, X, alphas, generator=generator)
    # kl_adaptive reads the LAST batch's KL (model.py:614)
    wu_alpha = (float(alphas[-1]) if alphas is not None
                else float(torch.sigmoid(torch.tensor(5.0 - last["last_raw_kl"]))))
    return state, wu_alpha


@dataclass
class AnalysisDraws:
    """Every random input of the analysis stage, drawn before it runs (the
    shapes depend only on N, K, K_z and the latent width):

      z_test_eps [N, zdim]: the encoded-z histogram's reparameterisation;
      cell_seed: gather_cell_samples' numpy seed;
      x_pairs: the X-space cells' index pairs, 2 x [K^2, CELL_PAIRS] in
        [0, CELL_SAMPLES);
      z_grid_eps [K_z^2, Z_GRID_SAMPLES, 2], z_pairs 2 x [K_z^2, CELL_PAIRS]
        in [0, Z_GRID_SAMPLES): the Z grid (these three None where the
        grid is skipped);
      data_eps, data_perm: data_based_z_samples' draws (data_perm None when
        N < DATA_SAMPLES);
      data_pairs: 2 x [DATA_PAIRS] in [0, DATA_SAMPLES)."""

    z_test_eps: torch.Tensor | None
    cell_seed: int
    x_pairs: tuple
    z_grid_eps: torch.Tensor | None
    z_pairs: tuple | None
    data_eps: torch.Tensor
    data_perm: torch.Tensor | None
    data_pairs: tuple


def draw_analysis(generator, n, zdim, K, K_z, grid=True) -> AnalysisDraws:
    """The analysis stage's draws from a CPU torch.Generator; `grid` False
    skips the Z grid's (JAX skips it unless --hidden_channels ends in 2)."""
    g = generator
    pairs = lambda high, shape: tuple(torch.randint(0, high, shape, generator=g)
                                      for _ in range(2))
    z_test_eps = torch.randn(n, zdim, generator=g) if grid else None
    cell_seed = int(torch.randint(0, 2 ** 31 - 1, (), generator=g))
    x_pairs = pairs(CELL_SAMPLES, (K * K, CELL_PAIRS))
    z_grid_eps = torch.randn(K_z * K_z, Z_GRID_SAMPLES, 2, generator=g) if grid else None
    z_pairs = pairs(Z_GRID_SAMPLES, (K_z * K_z, CELL_PAIRS)) if grid else None
    if n < DATA_SAMPLES:
        data_perm, data_eps = None, torch.randn(n, DATA_SAMPLES // n + 1, zdim, generator=g)
    else:
        data_perm = torch.randperm(n, generator=g)
        data_eps = torch.randn(DATA_SAMPLES, zdim, generator=g)
    return AnalysisDraws(z_test_eps, cell_seed, x_pairs, z_grid_eps, z_pairs, data_eps,
                         data_perm, pairs(DATA_SAMPLES, (DATA_PAIRS,)))


def analyse(model, X, K, K_z, draws: AnalysisDraws):
    """The analysis stage (lipschitz.py:384-484) on X [N, 2] (numpy) with the
    model on its device, under torch.no_grad(). Returns a dict of numpy
    fields (kl_x, lips_x, inv_x, bi_x over K^2 cells; z_test and
    z_plot_extent; kl_z, lips_z, inv_z, bi_z over K_z^2 cells; those six
    None where `draws` skip the grid) and the data-based floats (data_kl,
    data_inv, data_lips, data_bi)."""
    encode_fn, decode_fn, _ = make_apply_fns(model)
    dev = next(model.parameters()).device
    grid = draws.z_grid_eps is not None
    mu_all, log_var_all = encode_fn(torch.from_numpy(X).to(dev))
    out = {"z_test": None, "z_plot_extent": None}

    if grid:
        z_test = (mu_all + draws.z_test_eps.to(dev) * torch.exp(0.5 * log_var_all)).cpu().numpy()
        out["z_test"] = z_test
        out["z_plot_extent"] = [z_test[:, 0].min(), z_test[:, 0].max(),
                                z_test[:, 1].min(), z_test[:, 1].max()]

    # the K x K spatial grid over the data's bounding box (the mixture's
    # labels are component ids, so the points are re-binned, as in JAX)
    num_cells = K * K
    x_edges = np.linspace(X[:, 0].min(), X[:, 0].max() + 1e-6, K + 1)
    y_edges = np.linspace(X[:, 1].min(), X[:, 1].max() + 1e-6, K + 1)
    cx = np.clip(np.digitize(X[:, 0], x_edges) - 1, 0, K - 1)
    cy = np.clip(np.digitize(X[:, 1], y_edges) - 1, 0, K - 1)
    cell_labels = (cy * K + cx).astype(np.int32)

    kl_x, counts = analysis.per_cell_kl(mu_all, log_var_all, torch.from_numpy(cell_labels),
                                        num_cells)
    z_by_cell, valid, _ = analysis.gather_cell_samples(mu_all, log_var_all, cell_labels,
                                                       num_cells, draws.cell_seed, CELL_SAMPLES,
                                                       device=dev)
    inv_x, lips_x, bi_x = analysis.cellwise_decoder_lipschitz(
        decode_fn, z_by_cell, valid, idx1=draws.x_pairs[0], idx2=draws.x_pairs[1])
    kl_x = torch.where(counts > 0, kl_x, torch.full_like(kl_x,
                                                        analysis.DEFAULT_EMPTY_CELL_FILL_VALUE))
    out.update(kl_x=kl_x, inv_x=inv_x, lips_x=lips_x, bi_x=bi_x)

    out.update(kl_z=None, inv_z=None, lips_z=None, bi_z=None)
    if grid:
        zmin, zmax = float(out["z_plot_extent"][0]), float(out["z_plot_extent"][1])
        z_samples = analysis.z_grid_samples(K_z, zmin, zmax, 2, eps=draws.z_grid_eps, device=dev)
        kl_z = analysis.z_grid_kl(decode_fn, encode_fn, z_samples)
        inv_z, lips_z, bi_z = analysis.cellwise_decoder_lipschitz(
            decode_fn, z_samples, torch.ones(K_z * K_z, dtype=torch.bool, device=dev),
            idx1=draws.z_pairs[0], idx2=draws.z_pairs[1])
        out.update(kl_z=kl_z, inv_z=inv_z, lips_z=lips_z, bi_z=bi_z)
    out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v for k, v in out.items()}

    z_data, mu_sub, lv_sub = analysis.data_based_z_samples(
        mu_all, log_var_all, num_samples=DATA_SAMPLES, eps=draws.data_eps, perm=draws.data_perm)
    out["data_kl"] = analysis.data_based_kl(mu_sub, lv_sub)
    out["data_inv"], out["data_lips"], out["data_bi"] = analysis.data_based_lipschitz(
        decode_fn, z_data, i1=draws.data_pairs[0], i2=draws.data_pairs[1])
    return out


def _draw_plots(todo):
    """Write each PNG of `todo` [(fn, args, kwargs)]; where matplotlib is
    not installed, print which were not written."""
    missing, err = [], None
    for fn, args, kwargs in todo:
        try:
            fn(*args, **kwargs)
        except ImportError as e:
            missing.append(os.path.basename(kwargs["filepath"]))
            err = e
    if missing:
        print(f"plots {missing} not written: {err!r}", flush=True)


def main(argv=None):
    args = build_argparser().parse_args(argv)
    os.makedirs(args.output_dir, exist_ok=True)
    if args.seed is None:
        args.seed = 42
    device = torch.device(args.device)
    out_png = lambda name: os.path.join(args.output_dir, name)

    actual_latent_dim = args.hidden_channels[-1]
    if actual_latent_dim != 2:
        print(f"--- Warning: actual latent dimension ({actual_latent_dim}) is not 2;"
              f" Z-space grid evaluation will be skipped. ---")

    # 1. training data
    print(f"Generating training data with pattern: {args.distribution_pattern}")
    X, _y, *_ = generate_simple_gaussian_mixture(
        num_components=args.num_training_components,
        total_samples=args.train_total_samples,
        center_range=args.K,
        stds=args.std,
        pattern=args.distribution_pattern,
        seed=args.seed,
    )
    todo = [(plots.plot_2d_histogram, (X,), dict(
        bins=args.K, title=f"Training Data Distribution ({args.distribution_pattern})",
        filepath=out_png("train_distribution_2d.png")))]

    # 2. model + training
    is_lidvae = args.model == "lidvae"
    hchans = tuple(args.hidden_channels)
    weights_gen = torch.Generator().manual_seed(args.seed)
    if is_lidvae:
        print("Initializing and training LIDVAE model...")
        model = LIDVAE.for_dataset("pinwheel", hidden_channels=hchans,
                                   inverse_lipschitz=args.IL, beta=args.beta,
                                   generator=weights_gen)
        initial_wu = 0.0
    else:
        print("Initializing and training LRVAE model...")
        model = LRVAE.for_dataset("pinwheel", hidden_channels=hchans, encoder_type="mlp",
                                  decoder_type="mlp", alpha=args.alpha, beta=args.beta,
                                  generator=weights_gen)
        initial_wu = 1.0  # lipschitz.py:328 sets wu_alpha=1.0 up front
    model.to(device)

    grad_clip_cfg = {
        "enabled": args.grad_clip_enabled,
        "clip_type": args.grad_clip_type,
        "max_norm": args.grad_clip_max_norm,
        "norm_type": args.grad_clip_norm_type,
        "clip_value": args.grad_clip_value,
    }
    reg_label = "IL" if is_lidvae else "alpha"
    reg_value = args.IL if is_lidvae else args.alpha
    explog = create_experiment_logger(
        args.output_dir,
        f"{'LIDVAE' if is_lidvae else 'LRVAE'}_{reg_label}{reg_value}_beta{args.beta}",
    )
    explog.log_hyperparameters(
        model=("LIDVAE" if is_lidvae else "LRVAE"),
        alpha=(None if is_lidvae else args.alpha),
        IL=(args.IL if is_lidvae else None),
        beta=args.beta, epochs=args.epochs, lr=args.lr,
        batch_size=args.batch_size, K=args.K, K_z=args.K_z, std=args.std,
        train_total_samples=args.train_total_samples,
        distribution_pattern=args.distribution_pattern, seed=args.seed,
        latent_dim=actual_latent_dim, hidden_channels=args.hidden_channels,
        num_training_components=args.num_training_components,
        z_min=args.z_min, z_max=args.z_max, wu_strat=args.wu_strat,
        grad_clip_enabled=args.grad_clip_enabled,
    )

    t0 = time.perf_counter()
    train_model(model, torch.from_numpy(X).to(device), args, grad_clip_cfg, explog, initial_wu,
                generator=_generator(args.seed, _TRAIN))
    train_sec = time.perf_counter() - t0
    explog.log_model_info(model)
    print(f"Model training complete ({train_sec:.2f} s, {train_sec / max(args.epochs, 1):.4f} "
          f"s an epoch).")

    # 3. test data = train data (intentional, lipschitz.py:384-385)
    todo.append((plots.plot_2d_histogram, (X,), dict(
        bins=args.K, title="Test Data Distribution (X-space)",
        filepath=out_png("test_distribution_x_space.png"))))

    # 4-6. the fields and the data-based metrics
    print(f"\nEvaluating metrics based on X-space grid (K={args.K}) and Z-space grid "
          f"(K_z={args.K_z})...")
    t0 = time.perf_counter()
    draws = draw_analysis(_generator(args.seed, _ANALYSIS), len(X), model.latent_channel,
                          args.K, args.K_z, grid=actual_latent_dim == 2)
    f = analyse(model, X, args.K, args.K_z, draws)
    analysis_sec = time.perf_counter() - t0
    if f["z_test"] is not None:
        todo.append((plots.plot_2d_histogram, (f["z_test"],), dict(
            bins=args.K_z, title="Encoded Latent Z Distribution",
            filepath=out_png(f"encoded_z_alpha{args.alpha}.png"))))
        ext = f["z_plot_extent"]
        print(f"Z-space extent set to: x=[{ext[0]:.3f}, {ext[1]:.3f}]")
    z_plot_extent = f["z_plot_extent"] or [args.z_min, args.z_max, args.z_min, args.z_max]
    for space, k, sfx, extent in (("X", args.K, "x", None), ("Z", args.K_z, "z", z_plot_extent)):
        if f[f"kl_{sfx}"] is None:
            print("Z-space grid evaluation skipped (latent dim != 2).")
            continue
        for key, nm in ((f"kl_{sfx}", "kl_div"), (f"lips_{sfx}", "lips"),
                        (f"inv_{sfx}", "inv_lips"), (f"bi_{sfx}", "bi_lips")):
            todo.append((plots.plot_heatmap, (f[key], k, f"{nm} ({space}-space, "
                                                         f"{reg_label}={reg_value})"),
                         dict(filepath=out_png(f"{nm}_{sfx}_space_{reg_label}_{reg_value}.png"),
                              extent=extent)))
    data_kl, data_inv, data_lips, data_bi = (f["data_kl"], f["data_inv"], f["data_lips"],
                                             f["data_bi"])
    print(f"Data-based KL measurement: {data_kl:.4f}")
    print(f"Data-based L(z): inv={data_inv:.4f}, lips={data_lips:.4f}, bi={data_bi:.4f}")
    print(f"Analysis stage: {analysis_sec:.2f} s")
    _draw_plots(todo)

    # 7. CSVs (lipschitz.py:486-531)
    num_cells = args.K * args.K
    with open(os.path.join(args.output_dir, "experiment_metrics.csv"), "w", newline="") as fh:
        w = csv.writer(fh)
        w.writerow(["alpha", "space", "cell_idx", "kl_div", "lipschitz"])
        for i in range(num_cells):
            w.writerow([reg_value, "X", i, float(f["kl_x"][i]), float(f["lips_x"][i])])
        if f["kl_z"] is not None:
            for i in range(args.K_z * args.K_z):
                w.writerow([reg_value, "Z", i, float(f["kl_z"][i]), float(f["lips_z"][i])])

    exp_lip_file = os.path.join(os.path.dirname(args.output_dir) or ".", "exp_lip.csv")
    write_header = not os.path.exists(exp_lip_file)
    with open(exp_lip_file, "a", newline="") as fh:
        w = csv.writer(fh)
        if write_header:
            w.writerow(["alpha", "beta", "kl", "L(z)"])
        w.writerow([reg_value, args.beta, data_kl, data_bi])

    explog.log_evaluation_metrics(
        kl=data_kl, bi_lipschitz=data_bi, data_based_kl=data_kl,
        data_based_bi_lips=data_bi, data_based_inv_lips=data_inv,
        data_based_lips=data_lips,
    )
    explog.log_alpha_warmup_summary(args.wu_strat)
    explog.finalize_log()

    print(f"Experiment complete. Results saved to {args.output_dir}")
    print(f"Overall metrics - KL (data-based): {data_kl:.4f}, "
          f"Bi-Lipschitz L(z) (data-based): {data_bi:.4f}")
    return dict(kl=data_kl, bi_lips=data_bi, inv_lips=data_inv, lips=data_lips,
                train_sec=train_sec, analysis_sec=analysis_sec)


if __name__ == "__main__":
    main()
