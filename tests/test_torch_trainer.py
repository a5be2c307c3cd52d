"""The port's trainer and experiment CLI on the CPU, at a tiny size:
`run_experiment` writes the JAX trainer's artifact tree, its parameter
export loads into the JAX package, options it does not port raise, and
the helpers it copies from the JAX package (batches, warmup, posterior
metrics, TensorBoard records, unified CSV, config sweep) give the JAX
package's results. The trainer options that are ported (grad_accum,
resume_from, checkpoint_every, async_checkpoint) have their own file,
tests/test_torch_trainer_options.py."""

import csv
import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vae_song_tpu import config as jax_config
from vae_song_tpu import data as jax_data
from vae_song_tpu.data import pipeline as jax_pipeline
from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.ops import metrics as jax_metrics
from vae_song_tpu.ops import warmup as jax_warmup
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train import loggers as jax_loggers
from vae_song_tpu.train import tfevents as jax_tfevents
from vae_song_tpu.train.loop import init_model
from vae_song_tpu.train.steps import make_apply_fns as jax_apply_fns
from vae_song_tpu_torch import config, data
from vae_song_tpu_torch.cli import main as cli_main
from vae_song_tpu_torch.data.pipeline import iterate_batches
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.ops import metrics
from vae_song_tpu_torch.ops.warmup import warmup_alpha
from vae_song_tpu_torch.train import checkpoint, loggers, tfevents
from vae_song_tpu_torch.train.loop import train_and_test

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, LATENT = 128, 16
MODEL_PARAMS = dict(latent_channel=LATENT, num_points=N, d_model=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, ff_dim=64)
UNIFIED = ["name", "dataset_name", "epoch", "fid", "au", "kl", "mi", "nll",
           "vloss", "vlrec", "vlreg", "vllr", "mean_var"]
# f32 decode, JAX on its CPU path (bf16-rounded attention) against the
# port: measured 2.3e-4 at |cloud| <= 1.8 (tests/test_torch_setvae.py)
F32_RECON_ATOL = 2e-3


def _tiny_config(tmp_path, exp_type):
    common = {
        "niter": 1, "exp_epochs": 2, "batch_size": 8, "exp_data": "shapenet",
        "logfilename": f"log_{exp_type}.csv", "resultname": f"result_{exp_type}",
        "grad_clip": None, "dataset_params": {"num_points": N, "num_samples": 16,
                                              "num_test_samples": 8},
    }
    mp = dict(MODEL_PARAMS, beta_list=[0.001], mixed_precision=False)
    if exp_type == "setlrvae":
        common.update(grad_clip={"enabled": True, "clip_type": "norm", "max_norm": 1.0},
                      wu_strat="kl_adaptive")
        mp.update(alpha_list=[0.1], beta_list=[0.2])
    path = tmp_path / f"{exp_type}.yaml"
    path.write_text(yaml.safe_dump({"experiment_type": exp_type, "common_params": common,
                                    "model_params": mp}))
    return path


@pytest.mark.parametrize("exp_type", ["setvae", "setlrvae"])
def test_run_experiment_writes_the_jax_artifact_tree(tmp_path, exp_type):
    cfg = _tiny_config(tmp_path, exp_type)
    out = tmp_path / "out"
    (summary,) = cli_main.main(["--config", str(cfg), "--output_root", str(out),
                                "--fake_data", "--device", "cpu"])
    name = summary["name"]
    assert name.startswith("SetLRVAE" if exp_type == "setlrvae" else "SetVAE")
    run_dir = out / "results" / f"result_{exp_type}" / name
    assert summary["result_dir"] == str(run_dir)
    assert sorted(os.listdir(run_dir / "params")) == ["model_1.pkl"]
    plys = glob.glob(str(run_dir / "point_clouds" / "*.ply"))
    assert len(plys) == 12                       # 4 recon, 4 orig, 4 prior
    assert glob.glob(str(out / "runs" / name / "events.out.tfevents.*"))
    assert os.path.exists(run_dir / "log.txt")
    with open(out / "log" / f"log_{exp_type}.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == UNIFIED and len(rows) == 2
    assert rows[1][0] == name and rows[1][2] == "2"
    values = dict(zip(UNIFIED, rows[1]))
    assert all(np.isfinite(float(values[k])) for k in UNIFIED[3:])
    assert all(np.isfinite(v) for v in summary["eval"].values())


def test_saved_params_load_into_jax_and_decode_the_same_clouds(tmp_path):
    """`save_params_only` writes the JAX package's .pkl: it loads with the
    JAX `load_params_only` and decodes the clouds the port decodes."""
    port = build_model("setvae", "shapenet", MODEL_PARAMS,
                       generator=torch.Generator().manual_seed(3))
    path = str(tmp_path / "params" / "model_1.pkl")
    checkpoint.save_params_only(path, port)
    jmodel = jax_build_model("setvae", "shapenet", MODEL_PARAMS, beta=1.0)
    # the parameter tree's structure, shapes and dtypes, traced but not run
    template = jax.eval_shape(lambda x: init_model(jmodel, x)[0], np.zeros((2, N, 3), np.float32))
    params, _ = jax_ckpt.load_params_only(path, template)
    z = np.random.default_rng(4).normal(size=(3, LATENT)).astype(np.float32)
    _, jax_decode, _ = jax_apply_fns(jmodel)
    from vae_song_tpu.train.state import TrainState, make_optimizer
    want = np.asarray(jax_decode(TrainState.create(params, {}, make_optimizer(lr=0.0)),
                                 jnp.asarray(z)))
    with torch.inference_mode():
        got = port.eval().decode(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_RECON_ATOL, rtol=0)


@pytest.mark.parametrize("option,item", [
    ({"data_parallel": True}, "Queue 1 item 15"),
    ({"tensor_parallel": 2}, "Queue 1 item 15"),
    ({"fsdp": True}, "Queue 1 item 15"),
    ({"profile_dir": "prof"}, "Queue 1 item 16"),
    ({"pipeline_parallel": 2}, "Queue 1 item 15"),
    ({"sequence_parallel": 2}, "Queue 1 item 15"),
])
def test_unported_trainer_options_name_their_roadmap_item(tmp_path, option, item):
    model = build_model("setvae", "shapenet", MODEL_PARAMS)
    kwargs = dict(epochs=1, batch_size=8, dataset_name="shapenet",
                  dataset_params={"fake": True, "num_points": N, "num_samples": 8},
                  output_root=str(tmp_path), device="cpu")
    kwargs.update(option)
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md {item}"):
        train_and_test(model, **kwargs)
    assert not os.listdir(tmp_path)


def test_unported_dataset_raises():
    """A dataset name neither package knows (every dataset of the JAX
    package is ported)."""
    with pytest.raises(NotImplementedError, match="imagenet is not implemented"):
        data.load_dataset("imagenet")


def test_batches_match_the_jax_pipeline():
    """Same clouds (the fake set from the same seed) and the same shuffled,
    drop_last batches from np.random.default_rng([seed, epoch])."""
    kw = dict(fake=True, num_points=32, num_samples=20, seed=5)
    train, test, _ = data.load_dataset("shapenet", **kw)
    jtrain, jtest, _ = jax_data.load_dataset("shapenet", **kw)
    assert (len(train), len(test)) == (20, 5)
    np.testing.assert_array_equal(train.X, jtrain.X)
    np.testing.assert_array_equal(test.X, jtest.X)
    jds = jax_pipeline.ArrayDataset(jtrain.X, jtrain.y)
    for epoch in range(2):
        got = [x.numpy() for x, _ in iterate_batches(
            train, 6, rng=np.random.default_rng([5, epoch]))]
        want = [np.asarray(x) for x, _ in jax_pipeline.iterate_batches(
            jds, 6, rng=np.random.default_rng([5, epoch]))]
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    got = [x.numpy() for x, _ in iterate_batches(test, 2, shuffle=False)]
    assert len(got) == 2
    np.testing.assert_array_equal(np.concatenate(got), test.X[:4])


def test_directory_loader_matches_jax(tmp_path):
    """A ShapeNet-style directory (<root>/<class>/<split>/*.npy|npz|txt)
    gives the JAX loader's arrays, category filter included. The clouds
    hold exactly num_points points; clouds of other sizes, resampled
    through the native host library, are held in
    tests/test_torch_native.py."""
    rng = np.random.default_rng(8)
    for cls in ("airplane", "chair"):
        for split, count in (("train", 3), ("test", 2)):
            d = tmp_path / cls / split
            d.mkdir(parents=True)
            for i in range(count):
                pts = rng.normal(size=(32, 3)).astype(np.float32)
                if i == 0:
                    np.save(d / f"s{i}.npy", pts)
                elif i == 1:
                    np.savez(d / f"s{i}.npz", points=pts)
                else:
                    np.savetxt(d / f"s{i}.txt", pts)
    for category in (None, "chair"):
        kw = dict(shapenet_root=str(tmp_path), category=category, num_points=32, seed=3)
        got, want = data.load_dataset("shapenet", **kw), jax_data.load_dataset("shapenet", **kw)
        assert len(got[0]) == (3 if category else 6) and len(got[1]) == (2 if category else 4)
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_array_equal(g.X, w.X)
            np.testing.assert_array_equal(g.y, w.y)
    with pytest.raises(FileNotFoundError):
        data.load_dataset("shapenet", shapenet_root=str(tmp_path / "missing"))


@pytest.mark.parametrize("strat", ["linear", "exponential", "repeat_linear", "kl_adaptive"])
def test_warmup_matches_jax(strat):
    a = b = 0.0
    for epoch in range(12):
        kl = 3.0 + epoch
        a = warmup_alpha(a, epoch, 12, strat, last_kl_loss=kl)
        b = jax_warmup.warmup_alpha(b, epoch, 12, strat, last_kl_loss=kl)
        assert a == b


def test_posterior_metrics_match_jax(monkeypatch):
    """Same mu, logvar and noise: the port draws the MI noise, then the
    NLL noise, from its generator; JAX's draws are patched to the same
    numbers (measured 0 on AU, KL and the total variance, 1.9e-6 on MI
    and NLL)."""
    rng = np.random.default_rng(6)
    mu = rng.normal(size=(10, LATENT)).astype(np.float32)
    logvar = (rng.normal(size=(10, LATENT)) * 0.3 - 1.0).astype(np.float32)
    gen = torch.Generator().manual_seed(7)
    eps_mi = torch.randn(10, 1, LATENT, generator=gen).numpy()
    eps_nll = torch.randn(10, 100, LATENT, generator=gen).numpy()
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray({(10, 1, LATENT): eps_mi, (10, 100, LATENT): eps_nll}[tuple(shape)], dtype)
        if tuple(shape) in ((10, 1, LATENT), (10, 100, LATENT)) else normal(key, shape, dtype)))
    want = jax_metrics.measure_posterior_metrics(jax.random.PRNGKey(0), jnp.asarray(mu),
                                                 jnp.asarray(logvar), 0.7)
    got = metrics.measure_posterior_metrics(torch.Generator().manual_seed(7),
                                            torch.from_numpy(mu), torch.from_numpy(logvar),
                                            torch.tensor(0.7))
    assert got.keys() == want.keys()
    for k in got:
        assert float(got[k]) == pytest.approx(float(want[k]), rel=1e-5, abs=1e-5), k


def test_tfevents_records_match_jax(tmp_path):
    """Byte-identical event records, and the writer's file holds the
    version record and one record per scalar."""
    for tag, value, step, wall in (("loss/train", 1.25, 0, 1700000000.5),
                                   ("reg/train", -3.0e-7, 41, 1.0)):
        assert (tfevents._record(tfevents._scalar_event(tag, value, step, wall))
                == jax_tfevents._record(jax_tfevents._scalar_event(tag, value, step, wall)))
    assert tfevents._version_event(2.0) == jax_tfevents._version_event(2.0)
    writer = loggers.TensorBoardWriter(str(tmp_path / "runs"))
    writer.add_scalar("loss/train", 0.5, 0)
    writer.add_scalar("loss/test", 0.25, 0)
    writer.close()
    (path,) = glob.glob(str(tmp_path / "runs" / "events.out.tfevents.*"))
    raw = open(path, "rb").read()
    count, pos = 0, 0
    while pos < len(raw):
        length = int.from_bytes(raw[pos:pos + 8], "little")
        pos += 8 + 4 + length + 4
        count += 1
    assert pos == len(raw) and count == 3


def test_unified_csv_matches_jax(tmp_path):
    row = dict(zip(UNIFIED, ["SetVAE x", "shapenet", 2, -1, 0.5, 1.25, 0.1, 9.0,
                             0.3, 0.2, 0.1, 0.0, 7.0]))
    for _ in range(2):
        loggers.log_unified_dict(str(tmp_path / "port"), row, logfilename="u.csv")
        jax_loggers.log_unified_dict(str(tmp_path / "jax"), row, logfilename="u.csv")
    assert (open(tmp_path / "port" / "u.csv").read()
            == open(tmp_path / "jax" / "u.csv").read())


@pytest.mark.parametrize("name", ["config_shapenet_setvae.yaml",
                                  "config_shapenet_setlrvae.yaml", "config_mnist.yaml"])
def test_config_helpers_match_jax(name):
    path = os.path.join(ROOT, "configs", name)
    cfg = config.load_config(path)
    assert cfg == jax_config.load_config(path)
    assert config.resolve_names(cfg) == jax_config.resolve_names(cfg)
    assert list(config.sweep_grid(cfg)) == list(jax_config.sweep_grid(cfg))


def test_count_params_counts_every_parameter():
    model = build_model("setvae", "shapenet", MODEL_PARAMS)
    assert loggers.count_params(model) == sum(p.numel() for p in model.parameters())
