"""The port's trainer on image data (vae_song_tpu_torch/train/loop.py): a
short fake-MNIST run writes the last epoch's `valontr/` grids and `pca/`
plots; a resumed run with the MNIST augment ends where the continuous one
does, bit for bit; `native_prefetch` trains from the native loader;
generation-only mode (epochs < 0) writes its PNGs and a finite FID, the
JAX trainer's `_compute_fid` on the same images."""

import csv
import glob
import math
import os
import sys

import numpy as np
import pytest
import torch

from vae_song_tpu.train import loop as jax_loop
from vae_song_tpu_torch import data
from vae_song_tpu_torch.data import native
from vae_song_tpu_torch.models.flexible import LRVAE, VanillaVAE
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train import loop
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import adam_state
from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")

CLIP = {"enabled": True, "clip_type": "norm", "max_norm": 1.0, "norm_type": 2.0,
        "clip_value": 1.0}
# _compute_fid against JAX's on the same images: the random-conv features
# differ by summation order (1e-7, tests/test_torch_fid.py), which moves
# the score by about as much relative to it.
FID_RTOL = 1e-4


def _model(cls=VanillaVAE, seed=0, **kw):
    return cls.for_dataset("mnist", hidden_channels=(8, 8), latent_channel=2,
                           encoder_type="mlp", decoder_type="mlp",
                           generator=torch.Generator().manual_seed(seed), **kw)


def test_short_run_writes_grids_and_pca(tmp_path, monkeypatch):
    """The MNIST config's model family (LR-VAE, MLP, staged backward, L = 2)
    at a small width, one epoch of fake MNIST with its augment. Without
    scikit-learn, as on the card's machine: the PCA plots are written and
    t-SNE prints its error (its import and fit would take most of the
    test's time)."""
    monkeypatch.setitem(sys.modules, "sklearn", None)
    model = _model(LRVAE, beta=0.001, alpha=0.1)
    _, summary = train_and_test(model, epochs=1, batch_size=128, dataset_name="fake_mnist",
                                num_mc_samples=2, grad_clip=CLIP, resultname="res",
                                output_root=str(tmp_path), seed=0, device="cpu")
    run = summary["result_dir"]
    assert sorted(os.listdir(os.path.join(run, "valontr"))) == [
        f"0_{k}.png" for k in ("origin", "recon", "recon_wos", "sample")]
    pca = set(os.listdir(os.path.join(run, "pca")))
    assert {"prior.png", "0_pca_v_mu.png", "0_pca_v_z.png", "0_pca_all_mu.png"} <= pca
    assert os.listdir(os.path.join(run, "params")) == ["model_0.pkl"]
    assert all(math.isfinite(v) for v in summary["eval"].values())


def _same_state(a, b):
    same = all(torch.equal(v, w) for v, w in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))
    for name in ("mu", "nu"):
        same = same and all(torch.equal(v, w) for v, w in zip(
            adam_state(a)[name].values(), adam_state(b)[name].values()))
    return same and (a.optimizer.count, a.step) == (b.optimizer.count, b.step)


def test_resumed_augmented_run_equals_continuous(tmp_path, monkeypatch):
    """Two epochs with the MNIST augment (its draws from the per-epoch
    _AUGMENT stream) against one epoch, then a fresh model resumed from
    ckpt_0.pkl for the second: the same parameters, Adam state and step."""
    monkeypatch.setattr(loop, "_dump_artifacts", lambda *a, **k: None)
    kw = dict(epochs=2, batch_size=512, dataset_name="fake_mnist", grad_clip=CLIP, seed=3,
              device="cpu")
    cont, summary = train_and_test(_model(), output_root=str(tmp_path / "a"),
                                   checkpoint_every=1, **kw)
    ckpt = os.path.join(summary["result_dir"], "params", "ckpt_0.pkl")
    resumed, _ = train_and_test(_model(seed=1), output_root=str(tmp_path / "b"),
                                resume_from=ckpt, **kw)
    assert resumed.step == cont.step == 16
    assert _same_state(cont, resumed)
    # and the augment did run: without it the run ends elsewhere
    load = data.load_dataset
    monkeypatch.setattr(loop.data_lib, "load_dataset", lambda *a, **k: load(*a, **k)[:2] + (None,))
    plain, _ = train_and_test(_model(), output_root=str(tmp_path / "c"), **kw)
    assert not _same_state(cont, plain)


def test_native_prefetch_trains_from_the_loader(tmp_path, monkeypatch):
    monkeypatch.setattr(loop, "_dump_artifacts", lambda *a, **k: None)
    before = native.loader_batches
    state, summary = train_and_test(_model(), epochs=1, batch_size=512,
                                    dataset_name="fake_mnist", native_prefetch=True,
                                    output_root=str(tmp_path), seed=0, device="cpu")
    assert native.available() and native.loader_batches - before == state.step == 8
    assert all(math.isfinite(v) for v in summary["eval"].values())


def test_generation_only_mode(tmp_path):
    """epochs < 0 at batch_size 4: 50 x 4 PNGs from the pt_param
    checkpoint and a finite FID in the summary and the CSV row; the FID
    is the JAX trainer's on the same images."""
    pkl = str(tmp_path / "model_0.pkl")
    ckpt_lib.save_params_only(pkl, _model(seed=5))
    _, summary = train_and_test(_model(), epochs=-1, batch_size=4, dataset_name="fake_mnist",
                                pt_param=pkl, resultname="gen", output_root=str(tmp_path),
                                seed=0, device="cpu")
    pngs = glob.glob(os.path.join(summary["result_dir"], "generation", "*.png"))
    assert len(pngs) == 50 * 4
    with open(glob.glob(str(tmp_path / "log" / "*.csv"))[0]) as f:
        rows = list(csv.DictReader(f))
    assert float(rows[0]["fid"]) == pytest.approx(summary["fid"], rel=1e-9)
    assert math.isfinite(summary["fid"]) and summary["fid"] > 0

    _, test_ds, _ = data.load_dataset("fake_mnist")
    generated = np.random.default_rng(0).random((200, 28, 28, 1), dtype=np.float32)
    got = loop._compute_fid(test_ds, generated, "cpu")
    want = jax_loop._compute_fid(test_ds, generated)
    assert abs(got - want) <= FID_RTOL * abs(want)


def test_generation_only_mode_needs_images(tmp_path):
    model = LRVAE.for_dataset("pinwheel", hidden_channels=(4, 4), encoder_type="mlp",
                              decoder_type="mlp")
    with pytest.raises(ValueError, match="not an image dataset"):
        train_and_test(model, epochs=-1, batch_size=4, dataset_name="pinwheel",
                       output_root=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)
