"""The port's trainer on the FlexibleVAE family, on the CPU: the shipped
pinwheel config (configs/config_pinwheel.yaml: LR-VAE, twelve blocks of
16, B = 1024, two sweep points) cut to 2 epochs runs through the CLI and
writes the JAX trainer's artifact tree, its `model_1.pkl` loads into the
JAX LRVAE with the same forward; a resumed run replays the continuous
one bit for bit (L = 2 Monte-Carlo samples, two microbatches); without
matplotlib the run names the plots it did not write and goes on."""

import csv
import glob
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train.loop import init_model
from vae_song_tpu_torch.cli import main as cli_main
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import adam_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNIFIED = ["name", "dataset_name", "epoch", "fid", "au", "kl", "mi", "nll",
           "vloss", "vlrec", "vlreg", "vllr", "mean_var"]
SCATTER = ["input", "mu", "z", "recon", "sample"]
SMALL = dict(encoder_type="mlp", decoder_type="mlp", hchans=[8, 8, 8])


@pytest.fixture(autouse=True)
def one_thread():
    """These models' ops are tiny (width 16 at most): one intra-op thread
    runs them as fast as eight, and keeps the trainer runs from slowing
    to a crawl when other test processes share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pinwheel_config_runs_through_the_cli(tmp_path):
    with open(os.path.join(ROOT, "configs", "config_pinwheel.yaml")) as f:
        config = yaml.safe_load(f)
    config["common_params"]["exp_epochs"] = 2
    path = tmp_path / "pinwheel.yaml"
    path.write_text(yaml.safe_dump(config))
    out = tmp_path / "out"
    summaries = cli_main.main(["--config", str(path), "--output_root", str(out),
                               "--device", "cpu"])
    betas = config["model_params"]["beta_list"]
    assert len(summaries) == len(betas) == 2
    logfile = glob.glob(str(out / "log" / "*.csv"))
    assert len(logfile) == 1
    with open(logfile[0]) as f:
        rows = list(csv.reader(f))
    assert rows[0] == UNIFIED and len(rows) == 3
    for summary, beta, row in zip(summaries, betas, rows[1:]):
        name = summary["name"]
        assert name.startswith("LRVAE") and f"_b={float(beta)}_a=0.0001" in name
        run_dir = summary["result_dir"]
        assert sorted(os.listdir(os.path.join(run_dir, "params"))) == ["model_1.pkl"]
        assert sorted(os.listdir(os.path.join(run_dir, "scatter2d"))) == sorted(
            f"1_{k}.png" for k in SCATTER)
        assert glob.glob(str(out / "runs" / name / "events.out.tfevents.*"))
        assert row[0] == name and row[1] == "pinwheel" and row[2] == "2"
        assert all(np.isfinite(float(v)) for v in row[3:])
        assert all(np.isfinite(v) for v in summary["eval"].values())

    # the export loads into the JAX LRVAE and gives the port's forward
    mp = config["model_params"]
    pkl = os.path.join(summaries[0]["result_dir"], "params", "model_1.pkl")
    jmodel = jax_build_model("lrvae", "pinwheel", mp, beta=betas[0], alpha=0.0001)
    template = jax.eval_shape(lambda x: init_model(jmodel, x), np.zeros((2, 2), np.float32))
    params, bs = jax_ckpt.load_params_only(pkl, template[0], template[1])
    port = checkpoint.load_params_only(pkl, build_model("lrvae", "pinwheel", mp, beta=betas[0],
                                                        alpha=0.0001))
    x = np.random.default_rng(1).normal(size=(64, 2)).astype(np.float32)
    want = jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x),
                        latent_rand_sampling=False, train=False)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x))
    # eval mode, f32, twelve blocks each way: measured up to 2.3e-6 (z_recon)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5 * max(1.0, float(np.abs(w).max())))


def _train(root, **kwargs):
    model = build_model("lrvae", "pinwheel", SMALL, beta=0.01, alpha=0.5,
                        generator=torch.Generator().manual_seed(kwargs.pop("init_seed", 0)))
    # the points from a fixed seed: without one, as in JAX, every run draws
    # its own
    return train_and_test(model, epochs=3, batch_size=1024, dataset_name="pinwheel",
                          dataset_params={"seed": 4}, seed=3, output_root=str(root),
                          num_mc_samples=2, grad_accum=2, wu_strat="kl_adaptive",
                          device="cpu", **kwargs)


def test_resume_replays_the_continuous_run(tmp_path):
    """A run resumed from its epoch-0 checkpoint (a fresh model of other
    weights) ends where the continuous run did: parameters, statistics,
    Adam's moments, count and step bit for bit."""
    cont, summary = _train(tmp_path / "a", checkpoint_every=1)
    ckpt = os.path.join(summary["result_dir"], "params", "ckpt_0.pkl")
    resumed, _ = _train(tmp_path / "b", resume_from=ckpt, init_seed=1)
    for (k, v), w in zip(cont.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    for name in ("mu", "nu"):
        for v, w in zip(adam_state(cont)[name].values(), adam_state(resumed)[name].values()):
            assert torch.equal(v, w)
    assert (cont.optimizer.count, cont.step) == (resumed.optimizer.count, resumed.step) == (27, 27)


def test_scatter_plots_without_matplotlib_do_not_stop_the_run(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    _, summary = _train(tmp_path)
    assert "scatter2d plots ['input', 'mu', 'z', 'recon', 'sample'] not written" in \
        capsys.readouterr().out
    assert not os.path.exists(os.path.join(summary["result_dir"], "scatter2d"))
    assert os.listdir(os.path.join(summary["result_dir"], "params")) == ["model_2.pkl"]


def test_unported_model_names_its_roadmap_item(tmp_path):
    """Every model family of the JAX package is ported (LIDVAE last); a
    module of none of them is refused, naming the families the trainer
    takes, before anything is written."""
    with pytest.raises(TypeError, match="the FlexibleVAE family and LIDVAE; got Linear"):
        train_and_test(torch.nn.Linear(2, 2), epochs=1, dataset_name="pinwheel",
                       output_root=str(tmp_path), device="cpu")
    assert not os.listdir(tmp_path)


def test_generation_of_the_flexible_family_names_its_roadmap_item(tmp_path):
    """cli/generate.py generates for the FlexibleVAE family (held to JAX in
    tests/test_torch_generate.py), its int8 serving included (ROADMAP.md
    Queue 1 item 14, held to JAX in tests/test_torch_quant.py): the
    pinwheel config from a port checkpoint."""
    from vae_song_tpu_torch.cli import generate

    path = tmp_path / "pinwheel.yaml"
    path.write_text(open(os.path.join(ROOT, "configs", "config_pinwheel.yaml")).read())
    model = generate.create_model_from_config(yaml.safe_load(path.read_text()))
    ckpt = tmp_path / "params" / "model_0.pkl"
    checkpoint.save_params_only(str(ckpt), model)
    out = generate.main(["--config", str(path), "--param_dir", str(ckpt), "--n_samples", "8",
                         "--batch_size", "4", "--device", "cpu", "--quant", "int8"])
    assert out == str(tmp_path / "params" / "gen_samples")
