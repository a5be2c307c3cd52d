"""Trade-off figure CLI for the Lipschitz sweep (port of
vae_song_tpu/cli/figures.py, copied; matplotlib is imported where a
figure is drawn, so the module imports where it is not installed).

    python -m vae_song_tpu_torch.cli.figures --input_dir <dir of exp_lip_*.csv> \
        --output_dir output_figure

Consumes the ``exp_lip_<tag>.csv`` files appended by the lipschitz CLI
(columns ``alpha,beta,kl,L(z)``; one row per seed/run — see
reference behavior at lipschitz.py:486-531 and draw_figure/draw.py) and
renders, per tag, a two-panel SVG: KL-vs-beta on the left and local
bi-Lipschitz L(z)-vs-beta on the right, one curve per alpha, log y.

The visual constants (figure size, viridis curve palette with red for
the alpha=0 beta-VAE baseline, dashed-square / solid-circle markers,
2.2x text scale, log axes) ARE the published figure contract and match
the reference's output; everything else — data model, selection, and
CLI plumbing — is this framework's own design (no pandas; grouping is
a plain dict reduction).
"""

import argparse
import csv
import math
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

SWEEP_PREFIX = "exp_lip_"

# (column, prefer-smaller) per selection criterion. Criterion names are
# part of the CLI contract shared with the reference script.
_CRITERIA = {
    "kl_min": ("kl", True),
    "kl_max": ("kl", False),
    "lipschitz_min": ("lz", True),
    "lipschitz_max": ("lz", False),
}


@dataclass(frozen=True)
class SweepPoint:
    """One finished (alpha, beta, seed) run of the lipschitz CLI."""

    alpha: float
    beta: float
    kl: float
    lz: float  # data-based local bi-Lipschitz L(z)

    def finite(self):
        return all(map(math.isfinite, (self.alpha, self.beta, self.kl, self.lz)))


def discover_sweeps(directory):
    """Map sweep tag -> csv path for every exp_lip_*.csv under `directory`.

    The tag is the filename stem minus the shared prefix, e.g.
    ``exp_lip_protocolA_4seed.csv`` -> ``protocolA_4seed``.
    """
    out = {}
    for path in sorted(Path(directory).glob(SWEEP_PREFIX + "*.csv")):
        out[path.stem[len(SWEEP_PREFIX):]] = path
    return out


def read_sweep(path):
    """Parse one sweep CSV into SweepPoints, dropping non-finite rows."""
    points = []
    with open(path, newline="") as fh:
        for row in csv.DictReader(fh):
            try:
                p = SweepPoint(
                    alpha=float(row["alpha"]),
                    beta=float(row["beta"]),
                    kl=float(row["kl"]),
                    lz=float(row["L(z)"]),
                )
            except (KeyError, TypeError, ValueError):
                continue
            if p.finite():
                points.append(p)
    return points


def pick_representatives(points, criterion="kl_min"):
    """Collapse multi-seed runs to one point per (alpha, beta) cell.

    `criterion` picks which seed represents the cell (min/max of KL or
    of L(z)); ties keep the earliest row, matching append order.
    """
    if criterion not in _CRITERIA:
        raise ValueError(
            f"unknown criterion {criterion!r}; expected one of {sorted(_CRITERIA)}"
        )
    field, smaller = _CRITERIA[criterion]
    best = {}
    for p in points:
        cell = (p.alpha, p.beta)
        held = best.get(cell)
        if held is None:
            best[cell] = p
            continue
        score, held_score = getattr(p, field), getattr(held, field)
        if (score < held_score) if smaller else (score > held_score):
            best[cell] = p
    return [best[cell] for cell in sorted(best)]


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _curve_style(alpha, rank, total):
    """Color + legend label for one alpha curve (red = beta-VAE baseline)."""
    plt = _pyplot()
    if alpha == 0.0:
        return "#CC0000", f"α={alpha} (β-VAE)"
    palette = plt.cm.viridis(np.linspace(0, 1, total))
    return palette[rank], f"α={alpha} (Ours)"


def render_tradeoff(cells, out_path, text_scale=2.2):
    """Render the two-panel KL / L(z) trade-off figure to `out_path`."""
    plt = _pyplot()
    alphas = sorted({p.alpha for p in cells})
    betas = sorted({p.beta for p in cells})
    fig, (ax_kl, ax_lz) = plt.subplots(1, 2, figsize=(16, 8))

    for rank, alpha in enumerate(alphas):
        curve = sorted((p for p in cells if p.alpha == alpha), key=lambda p: p.beta)
        if not curve:
            continue
        color, label = _curve_style(alpha, rank, len(alphas))
        xs = [p.beta for p in curve]
        ax_kl.plot(xs, [p.kl for p in curve], "--s", color=color,
                   linewidth=4, markersize=14, label=label)
        ax_lz.plot(xs, [p.lz for p in curve], "-o", color=color,
                   linewidth=4, markersize=14, label=label)

    panels = [
        (ax_kl, "Mean KLD", "KL Divergence with β"),
        (ax_lz, "Mean L(z)", "Local bi-Lipschitz with β"),
    ]
    for ax, y_name, title in panels:
        ax.set_xlabel("β (Regularization Weight)", fontsize=14 * text_scale)
        ax.text(-0.05, 0.75, y_name, transform=ax.transAxes,
                fontsize=14 * text_scale, rotation=90, ha="center", va="top")
        ax.set_yscale("log")
        ax.grid(True, alpha=0.3)
        ax.set_title(title, fontsize=16 * text_scale)
        ax.legend(fontsize=10 * text_scale)
        ax.set_xticks(betas)
        ax.tick_params(axis="both", which="major", labelsize=14 * text_scale)

    plt.tight_layout()
    plt.subplots_adjust(wspace=0.16)
    fig.savefig(out_path, format="svg", dpi=300, bbox_inches="tight")
    plt.close(fig)


def build_figures(input_dir, output_dir, criterion="kl_min", only=None):
    """Render one trade-off SVG per discovered sweep; returns output paths."""
    sweeps = discover_sweeps(input_dir)
    if not sweeps:
        print(f"figures: no {SWEEP_PREFIX}*.csv under {input_dir}")
        return []
    if only is not None:
        if only not in sweeps:
            print(f"figures: tag {only!r} not among {sorted(sweeps)}")
            return []
        sweeps = {only: sweeps[only]}

    os.makedirs(output_dir, exist_ok=True)
    written = []
    for tag, path in sweeps.items():
        points = read_sweep(path)
        print(f"figures: {tag}: {len(points)} finite rows from {path}")
        cells = pick_representatives(points, criterion)
        if not cells:
            print(f"figures: {tag}: nothing to plot, skipping")
            continue
        out_path = os.path.join(output_dir, f"{tag}_plot.svg")
        render_tradeoff(cells, out_path)
        print(f"figures: wrote {out_path}")
        written.append(out_path)
    return written


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="Render KL / bi-Lipschitz trade-off figures from lipschitz sweep CSVs"
    )
    parser.add_argument("--input_dir", type=str, default="input_data")
    parser.add_argument("--output_dir", type=str, default="output_figure")
    parser.add_argument("--selection_method", type=str, default="kl_min",
                        choices=sorted(_CRITERIA))
    parser.add_argument("--experiment", type=str, default=None,
                        help="render only this sweep tag")
    args = parser.parse_args(argv)
    build_figures(args.input_dir, args.output_dir,
                  criterion=args.selection_method, only=args.experiment)


if __name__ == "__main__":
    main()
