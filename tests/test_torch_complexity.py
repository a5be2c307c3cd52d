"""cli/complexity.py in the port against the JAX package's
(vae_song_tpu/cli/complexity.py): `train_one_model` for each of the three
models it benchmarks, on tiny stand-in images, and the CSV's columns."""

import ast
import csv
import os

import numpy as np
import pytest
import torch

from vae_song_tpu_torch.cli import complexity
from vae_song_tpu_torch.data.pipeline import ArrayDataset
from vae_song_tpu_torch.models.flexible import LRVAE, VanillaVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE

from jax_parity import one_thread  # noqa: F401  (a fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HIDDEN = (8, 8)
MODELS = {
    "VanillaVAE": lambda: VanillaVAE.for_dataset("mnist", hidden_channels=HIDDEN, beta=1.0,
                                                 encoder_type="conv", decoder_type="mlp"),
    "LIDVAE": lambda: LIDVAE.for_dataset("mnist", hidden_channels=HIDDEN, beta=1.0),
    "LRVAE": lambda: LRVAE.for_dataset("mnist", hidden_channels=HIDDEN, beta=1.0, alpha=0.1,
                                       encoder_type="conv", decoder_type="mlp"),
}


def _images(n=16, seed=0):
    x = np.random.default_rng(seed).uniform(size=(n, 28, 28, 1)).astype(np.float32)
    return ArrayDataset(x, np.zeros(n, np.int64))


@pytest.mark.parametrize("epochs", [0, 1])
@pytest.mark.parametrize("name", list(MODELS))
def test_train_one_model_runs(one_thread, name, epochs):
    """As JAX's tests/test_complexity_cli.py, for each model: epochs=0 (the
    first calls and the eval only) reports a row, not an error, and the
    parameters stay finite; JAX's metric keys; each model trains with its
    own gradient mode (LRVAE staged, the others composite)."""
    model = MODELS[name]()
    ds = _images()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    model, row = complexity.train_one_model(model, ds, ds, augment=None, epochs=epochs,
                                            batch_size=8, device="cpu")
    assert list(row) == ["train_time_sec", "eval_time_sec", "train_memory_mb", "eval_memory_mb",
                         "train_gpu_memory_mb", "eval_gpu_memory_mb", "eval_losses"]
    assert row["train_time_sec"] >= 0.0 and np.isfinite(row["eval_time_sec"])
    assert row["train_gpu_memory_mb"] == row["eval_gpu_memory_mb"] == 0.0
    assert len(row["eval_losses"]) == 4 and all(np.isfinite(v) for v in row["eval_losses"])
    assert all(torch.isfinite(p).all() for p in model.parameters())
    moved = any(not torch.equal(v, model.state_dict()[k]) for k, v in before.items())
    assert moved == (epochs > 0)      # the warm-up step ran on a copy
    assert model.grad_mode == ("staged" if name == "LRVAE" else "composite")


def _jax_columns():
    """The keys of the row dict JAX's main appends, in order (read from its
    source: running JAX's main trains three full-size MNIST models)."""
    tree = ast.parse(open(os.path.join(ROOT, "vae_song_tpu", "cli", "complexity.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "append"
                and node.args and isinstance(node.args[0], ast.Dict)):
            return [k.value for k in node.args[0].keys]
    raise AssertionError("no results.append({...}) in the JAX CLI")


def test_main_writes_jax_columns(one_thread, tmp_path, monkeypatch):
    """main on tiny stand-in images (the loader patched to 16 of them, the
    models' hidden widths to 8):
    three rows, VanillaVAE, LIDVAE and LRVAE, with the JAX CSV's columns in
    its order; the weights exported; the grids written, or a line naming
    them where matplotlib is missing."""
    monkeypatch.setattr(complexity.data_lib, "load_dataset",
                        lambda name, **kw: (_images(16, 1), _images(8, 2), None))
    for cls in (VanillaVAE, LIDVAE, LRVAE):     # narrow models
        monkeypatch.setattr(cls, "for_dataset", classmethod(
            lambda c, *a, wide=cls.for_dataset, **k: wide(*a, hidden_channels=HIDDEN, **k)))
    out = str(tmp_path / "out")
    complexity.main(["--output_dir", out, "--epochs", "1", "--batch_size", "8",
                     "--device", "cpu"])
    with open(os.path.join(out, "complexity_results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == _jax_columns()
    assert [r[0] for r in rows[1:]] == ["VanillaVAE", "LIDVAE", "LRVAE"]
    assert sorted(os.listdir(os.path.join(out, "weights"))) == [
        "LIDVAE.pkl", "LRVAE.pkl", "VanillaVAE.pkl"]
