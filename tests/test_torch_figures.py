"""The port's trade-off figure CLI (vae_song_tpu_torch/cli/figures.py)
against the JAX package's on the fixtures of tests/test_figures_cli.py:
the same sweeps found, the same points read and picked, the same figure
contract written; and the module imports where matplotlib is missing."""

import importlib
import os
import sys

import pytest

from vae_song_tpu.cli import figures as jax_figures
from vae_song_tpu_torch.cli import figures

from test_figures_cli import CSV_HEADER, sweep_dir  # noqa: F401  (the fixture)


def test_discover_and_read_match_jax(sweep_dir, tmp_path):  # noqa: F811
    assert {k: str(v) for k, v in figures.discover_sweeps(sweep_dir).items()} == {
        k: str(v) for k, v in jax_figures.discover_sweeps(sweep_dir).items()}
    for path in (sweep_dir / "exp_lip_toyA.csv", sweep_dir / "exp_lip_toyB.csv"):
        assert [tuple(vars(p).values()) for p in figures.read_sweep(path)] == [
            tuple(vars(p).values()) for p in jax_figures.read_sweep(path)]
    bad = tmp_path / "exp_lip_mangled.csv"
    bad.write_text(CSV_HEADER + "0.1,0.1,oops,1.0\n0.2,0.2,1.0,2.0\n")
    assert [(p.alpha, p.beta) for p in figures.read_sweep(bad)] == [(0.2, 0.2)]


@pytest.mark.parametrize("criterion", ["kl_min", "kl_max", "lipschitz_min", "lipschitz_max"])
def test_pick_representatives_match_jax(sweep_dir, criterion):  # noqa: F811
    pts = figures.read_sweep(sweep_dir / "exp_lip_toyA.csv")
    jpts = jax_figures.read_sweep(sweep_dir / "exp_lip_toyA.csv")
    got = [tuple(vars(p).values()) for p in figures.pick_representatives(pts, criterion)]
    want = [tuple(vars(p).values()) for p in jax_figures.pick_representatives(jpts, criterion)]
    assert got == want and len(got) == 4
    with pytest.raises(ValueError):
        figures.pick_representatives(pts, "elbo_min")


def test_build_figures_and_main_write_the_contract(sweep_dir, tmp_path, capsys):  # noqa: F811
    out_dir = tmp_path / "figs"
    written = figures.build_figures(sweep_dir, out_dir)
    assert sorted(os.path.basename(p) for p in written) == ["toyA_plot.svg", "toyB_plot.svg"]
    svg = (out_dir / "toyA_plot.svg").read_text()
    assert "KL Divergence with" in svg and "Local bi-Lipschitz with" in svg
    assert "-VAE)" in svg and "(Ours)" in svg
    assert figures.build_figures(sweep_dir, out_dir, only="missing") == []
    empty = tmp_path / "empty"
    empty.mkdir()
    assert figures.build_figures(empty, out_dir) == []
    said = capsys.readouterr().out
    assert "not among" in said and "no exp_lip_" in said
    figures.main(["--input_dir", str(sweep_dir), "--output_dir", str(tmp_path / "cli"),
                  "--selection_method", "lipschitz_min", "--experiment", "toyA"])
    assert os.listdir(tmp_path / "cli") == ["toyA_plot.svg"]


def test_imports_without_matplotlib(sweep_dir, tmp_path, monkeypatch):  # noqa: F811
    """The card's machine has no matplotlib: the module imports and reads
    the sweeps; drawing raises ImportError."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    mod = importlib.reload(figures)
    try:
        pts = mod.pick_representatives(mod.read_sweep(sweep_dir / "exp_lip_toyB.csv"))
        assert len(pts) == 2
        with pytest.raises(ImportError):
            mod.render_tradeoff(pts, str(tmp_path / "x.svg"))
    finally:
        monkeypatch.undo()
        importlib.reload(figures)
