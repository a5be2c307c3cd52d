"""The paper's alpha trade-off on the PyTorch port, on the card: the
Lipschitz sweep (vae_song_tpu_torch.parallel.sweep.run_sweep) of LR-VAE at
beta 0.1, alpha 0 and 0.1, seed 42, with protocol B's two training
components, as res_share/lip_grid_r3 ran the JAX package.

    python scripts/lipschitz_tradeoff_torch.py [--epochs 1000] [--out results/tradeoff]

Prints the card (nvidia-smi name and power limit), one line a point and a
JSON line of the points' data-based KL and L(z); the sweep's tree, with
its exp_lip.csv, goes under --out.
"""

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from vae_song_tpu_torch.parallel.sweep import run_sweep  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--alphas", nargs="+", type=float, default=[0.0, 0.1])
    p.add_argument("--beta", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default="results/tradeoff")
    p.add_argument("--device", type=str, default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip(), flush=True)
    res = run_sweep("lrvae", alphas=tuple(args.alphas), betas=(args.beta,), seeds=(args.seed,),
                    epochs=args.epochs, output_root=args.out,
                    extra_args=("--num_training_components", "2"), device=args.device)
    for r in res:
        print(f"alpha {r['alpha']} beta {r['beta']} seed {r['seed']} epochs {args.epochs}: "
              + (f"KL {r['kl']:.6g}, L(z) {r['bi_lips']:.6g}, train {r['train_sec']:.1f} s, "
                 f"analysis {r['analysis_sec']:.1f} s, point {r['wall_sec']:.1f} s" if r["ok"]
                 else f"failed: {r['error']}"), flush=True)
    print(json.dumps({"epochs": args.epochs, "points": res}))
    if not all(r["ok"] for r in res):
        sys.exit(1)


if __name__ == "__main__":
    main()
