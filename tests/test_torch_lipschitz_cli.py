"""The port's Lipschitz CLI (cli/lipschitz.py) and sweep runner
(parallel/sweep.py) against the JAX package's on the CPU, at a small
size: JAX's `cli.lipschitz.main` trains and analyses LIDVAE; its trained
parameters are carried into the port, whose analysis stage runs on the
draws JAX's keys give (the test repeats JAX's key splits), and the
fields of JAX's experiment_metrics.csv and its data-based metrics must
come out again (the LR-VAE's run: tests/test_torch_lipschitz_lrvae.py).
Then the port's own CLI and sweep runs, which write the CSVs with JAX's
columns and row counts."""

import os
import sys

import numpy as np
import pytest

from vae_song_tpu_torch.cli import lipschitz
from vae_song_tpu_torch.parallel import sweep

from jax_parity import (LIPSCHITZ_ARGS, LIPSCHITZ_SMALL as SMALL, check_lipschitz_analysis,
                        csv_rows, lipschitz_jax_run)


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """JAX's CLI on LIDVAE (the LR-VAE's run is in
    tests/test_torch_lipschitz_lrvae.py)."""
    return {"lidvae": lipschitz_jax_run(SMALL + LIPSCHITZ_ARGS["lidvae"],
                                        tmp_path_factory.mktemp("jax_lidvae") / "run")}


@pytest.mark.parametrize("model", ["lidvae"])
def test_analysis_stage_matches_jax(jax_runs, model):
    """JAX-trained LIDVAE parameters, JAX's data and JAX's draws: the port's
    X and Z fields and data-based metrics (`check_lipschitz_analysis`)."""
    check_lipschitz_analysis(jax_runs[model], SMALL + LIPSCHITZ_ARGS[model])


def test_cli_writes_jax_csvs(jax_runs, tmp_path, capsys):
    """The port's CLI at 2 epochs on the CPU: experiment_metrics.csv with
    JAX's columns, K^2 + K_z^2 rows and JAX's cell order; ../exp_lip.csv
    with JAX's header and one row a run (appended); finite metrics; the
    log; the PNGs, or where matplotlib is missing a line naming them."""
    out = tmp_path / "sweep" / "run"
    for model in LIPSCHITZ_ARGS:
        metrics = lipschitz.main(SMALL + LIPSCHITZ_ARGS[model] + ["--output_dir", str(out), "--device",
                                                        "cpu"])
        assert all(np.isfinite(v) for v in metrics.values())
        rows = csv_rows(out / "experiment_metrics.csv")
        want = jax_runs["lidvae"]["fields"]   # the same columns, rows and cells for both
        assert rows[0] == want[0] and len(rows) == len(want)
        reg = "0.2" if model == "lidvae" else "0.1"
        assert [r[1:3] for r in rows] == [r[1:3] for r in want]
        assert {r[0] for r in rows[1:]} == {reg}
        assert os.path.exists(out / "log.txt")
    exp_lip = csv_rows(out.parent / "exp_lip.csv")
    assert exp_lip[0] == jax_runs["lidvae"]["exp_lip"][0] == ["alpha", "beta", "kl", "L(z)"]
    assert len(exp_lip) == 3 and [r[0] for r in exp_lip[1:]] == ["0.1", "0.2"]
    pngs = sorted(p for p in os.listdir(out) if p.endswith(".png"))
    # the three histograms (encoded_z named by --alpha in both runs, as in
    # JAX) and each run's eight heatmaps, named by its alpha or IL
    assert len(pngs) == 3 + 8 + 8
    assert "not written" not in capsys.readouterr().out


def test_cli_without_matplotlib_writes_the_csvs(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "run"
    metrics = lipschitz.main(SMALL + LIPSCHITZ_ARGS["lrvae"] + ["--output_dir", str(out), "--device",
                                                      "cpu"])
    assert np.isfinite(metrics["bi_lips"])
    said = capsys.readouterr().out
    assert "plots ['train_distribution_2d.png', 'test_distribution_x_space.png'" in said
    assert "not written" in said
    assert not [p for p in os.listdir(out) if p.endswith(".png")]
    assert len(csv_rows(out / "experiment_metrics.csv")) == 1 + 16 + 9
    assert len(csv_rows(tmp_path / "exp_lip.csv")) == 2


def test_sweep_records_every_point(tmp_path, monkeypatch):
    """run_sweep (one process): a row a point in exp_lip.csv and ok True;
    a point that raises is recorded with ok False and its error, and the
    sweep goes on. main takes the JAX runner's flags and --device."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    extra = ("--train_total_samples", "300", "--hidden_channels", "8", "2", "--batch_size",
             "64", "--device", "cpu")
    res = sweep.run_sweep("lrvae", alphas=(0.0, 0.1), betas=(0.1,), seeds=(3,), epochs=1,
                          output_root=str(tmp_path / "a"), extra_args=extra)
    assert [(r["alpha"], r["ok"]) for r in res] == [(0.0, True), (0.1, True)]
    assert all(np.isfinite(r["bi_lips"]) for r in res)
    assert len(csv_rows(tmp_path / "a" / "exp_lip.csv")) == 3
    assert os.path.isdir(tmp_path / "a" / "alpha_0.1_beta_0.1_seed_3")
    seen = []
    monkeypatch.setattr(sweep, "run_sweep", lambda *a, **k: seen.append((a, k)) or [])
    sweep.main(["--model", "lidvae", "--ils", "0.1", "--betas", "1.0", "--seeds", "4",
                "--epochs", "7", "--output_root", "out", "--device", "cpu"])
    assert seen == [(("lidvae", (0.0, 0.1, 0.2, 0.3, 0.4), (0.1,), (1.0,), (4,), 7, "out"),
                     {"device": "cpu"})]
    monkeypatch.undo()
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    res = sweep.run_sweep("lidvae", ils=(0.1,), betas=(1.0,), seeds=(4,), epochs=1,
                          output_root=str(tmp_path / "c"),
                          extra_args=("--batch_size", "100000", "--device", "cpu"))
    assert not res[0]["ok"] and "smaller than one batch" in res[0]["error"]


def test_cli_skips_the_z_grid_unless_the_hidden_widths_end_in_2(tmp_path, monkeypatch, capsys):
    """As JAX's CLI: --hidden_channels ending in another width than 2 skips
    the encoded-z histogram and the Z grid (K^2 field rows only); the
    data-based metrics are still written."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = tmp_path / "run"
    metrics = lipschitz.main(SMALL + ["--model", "lrvae", "--hidden_channels", "8", "4",
                                      "--output_dir", str(out), "--device", "cpu"])
    assert np.isfinite(metrics["kl"]) and np.isfinite(metrics["bi_lips"])
    said = capsys.readouterr().out
    assert "Z-space grid evaluation will be skipped" in said and "encoded_z" not in said
    rows = csv_rows(out / "experiment_metrics.csv")
    assert len(rows) == 1 + 16 and {r[1] for r in rows[1:]} == {"X"}
