"""The port's trainer options against the JAX package on the CPU:
gradient accumulation (`grad_accum`, `make_accum_train_step`), the
full-state checkpoint and its map from optax's state, `resume_from`,
`checkpoint_every` and `async_checkpoint`, `use_cosine`, `progress` and
`visualize_artifacts`. Every bound sits beside the difference it was set
from; the resume checks are bitwise.
"""

import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml
from flax import serialization

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.loop import train_and_test as jax_train_and_test
from vae_song_tpu.train.steps import make_accum_train_step as jax_make_accum_train_step
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.cli import main as cli_main
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import TrainState, adam_state, load_optax_state, make_optimizer
from vae_song_tpu_torch.train.steps import make_accum_train_step, make_train_step

from jax_parity import grads_capture, one_thread, patch_eps, to_np  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, LATENT, N_MICRO = 8, 128, 16, 2
ATTN = dict(latent_channel=LATENT, num_points=N, d_model=128, num_heads=2,
            num_encoder_layers=1, num_decoder_layers=1, ff_dim=64)
DEEPSETS = dict(latent_channel=LATENT, num_points=N, use_attention=False,
                encoder_hidden=[32, 64], decoder_hidden=[64, 32])
BETA, ALPHA, WU_ALPHA, LR = 0.001, 0.5, 0.3, 1e-2
CLIP = {"enabled": True, "clip_type": "norm", "max_norm": 1.0}


def _pair(kind, mp, seed=0):
    """The JAX model and variables (the port's seeded weights through the
    weight map), and the port model."""
    port = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA,
                       generator=torch.Generator().manual_seed(seed))
    variables = weights.state_dict_to_variables(port.state_dict())
    return jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA), variables, port


def _data(seed, batch=B):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(batch, N, 3)) * 0.5).astype(np.float32)
    return x, rng.normal(size=(batch, LATENT)).astype(np.float32)


# ---------------------------------------------------------------- grad_accum


# One accumulated step (2 microbatches of 4) from the same weights:
# (loss terms relative, gradient relative L2, running statistics). The
# attention model, f32: JAX's CPU attention rounds q, k, v and P to bf16
# and the port's does not, as in tests/test_torch_train.py (its
# CPU_F32_BOUNDS: 5e-4 and 0.05 on a first step): measured 4.3e-6 and
# 7.3e-4. DeepSets SetLRVAE, f32 (the BatchNorm statistics move one
# microbatch after another, twice each for the encoder; the latent term
# carries the 1/n_micro): measured 4.9e-7, 1.1e-5 and 3.0e-7, bounds
# 1e-5, 1e-4, 1e-5.
@pytest.mark.parametrize("kind,mp,bounds", [
    ("setvae", ATTN, (5e-4, 0.05, None)),
    ("setlrvae", DEEPSETS, (1e-5, 1e-4, 1e-5)),
])
def test_accum_step_matches_jax(monkeypatch, kind, mp, bounds):
    """JAX's lax.scan traces its body once, so a patched
    jax.random.normal hands every microbatch the same eps block: the port
    gets that block tiled over the batch."""
    jmodel, variables, port = _pair(kind, mp)
    x, eps = _data(seed=1, batch=B // N_MICRO)
    x = np.concatenate([x, _data(seed=2, batch=B // N_MICRO)[0]])
    patch_eps(monkeypatch, eps)
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=LR))
    state = jax_state.TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                        jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                        tx)
    state, jm = jax_make_accum_train_step(jmodel, tx, N_MICRO)(
        state, jnp.asarray(x), WU_ALPHA, jax.random.PRNGKey(0))
    keys = [k for k, _ in port.named_parameters()]
    j_grads = weights.params_to_state_dict(to_np(state.opt_state[0]), keys)

    pm = make_accum_train_step(port, make_optimizer(port.parameters(), lr=LR), N_MICRO)(
        torch.from_numpy(x), torch.from_numpy(np.tile(eps, (N_MICRO, 1))), WU_ALPHA)
    rel = max(abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-6)
              for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    live = [k for k, p in port.named_parameters() if p.grad is not None
            and not k.endswith("key.bias") and k not in pre_batchnorm_biases(keys)]
    num = sum(float(((port.get_parameter(k).grad - j_grads[k]) ** 2).sum()) for k in live)
    den = sum(float((j_grads[k] ** 2).sum()) for k in live)
    assert rel <= bounds[0] and (num / den) ** 0.5 <= bounds[1], (rel, (num / den) ** 0.5)
    if bounds[2] is not None:
        got = weights.state_dict_to_variables(port.state_dict())["batch_stats"]
        for path, want in jax.tree_util.tree_flatten_with_path(to_np(state.batch_stats))[0]:
            leaf = got
            for p in path:
                leaf = leaf[p.key]
            assert float(np.abs(leaf - want).max()) <= bounds[2] * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("kind,mp", [("setvae", ATTN), ("setlrvae", DEEPSETS)])
def test_accum_step_is_the_explicit_microbatch_mean(kind, mp):
    """The accumulated gradient is 0 + g_0 / n + g_1 / n over the
    microbatches, the metrics the same mean, bit for bit; for SetVAE,
    whose loss terms are batch means, it is the full batch's gradient up
    to roundoff (measured 9.7e-7 relative L2; bound 1e-5)."""
    x, eps = (torch.from_numpy(a) for a in _data(seed=3))
    port = _pair(kind, mp, seed=4)[2]
    reference = _pair(kind, mp, seed=4)[2].train()
    params = list(reference.parameters())
    acc, metrics = [None] * len(params), 0.0
    for xi, ei in zip(x.split(B // N_MICRO), eps.split(B // N_MICRO)):
        outs = reference(xi, ei)
        total, rec, reg, lr = reference.loss(xi, *outs, wu_alpha=WU_ALPHA)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        for i, g in enumerate(grads):
            if g is not None:
                acc[i] = g / N_MICRO if acc[i] is None else acc[i] + g / N_MICRO
        metrics = metrics + torch.stack([total, rec, reg, lr]).detach() / N_MICRO
    m = make_accum_train_step(port, make_optimizer(port.parameters(), lr=LR), N_MICRO)(
        x, eps, WU_ALPHA)
    assert torch.equal(torch.stack([m[k] for k in ("loss", "recon", "reg", "lr")]), metrics)
    for p, g in zip(port.parameters(), acc):
        assert (p.grad is None) == (g is None)
        if g is not None:
            assert torch.equal(p.grad, g)
    for a, b in zip(port.buffers(), reference.buffers()):
        assert torch.equal(a, b)
    if kind == "setvae":
        full = _pair(kind, mp, seed=4)[2]
        make_train_step(full, make_optimizer(full.parameters(), lr=LR))(x, eps, WU_ALPHA)
        pairs = [(p.grad, q.grad) for p, q in zip(port.parameters(), full.parameters())
                 if q.grad is not None]
        num = sum(float(((a - b) ** 2).sum()) for a, b in pairs)
        den = sum(float((b ** 2).sum()) for _, b in pairs)
        assert (num / den) ** 0.5 <= 1e-5


def test_grad_accum_refuses_a_batch_it_does_not_divide(tmp_path):
    """The JAX trainer's check and message."""
    kw = dict(epochs=1, batch_size=8, dataset_name="shapenet", grad_accum=3,
              dataset_params={"fake": True, "num_points": 16, "num_samples": 16},
              output_root=str(tmp_path))
    with pytest.raises(ValueError) as want:
        jax_train_and_test(jax_build_model("setvae", "shapenet", dict(
            latent_channel=4, num_points=16, d_model=16, num_heads=2, ff_dim=32)),
            visualize_artifacts=False, progress=False, **kw)
    with pytest.raises(ValueError) as got:
        train_and_test(build_model("setvae", "shapenet", dict(ATTN, num_points=16)),
                       device="cpu", **kw)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------- optax state


def test_jax_train_state_carries_across(monkeypatch):
    """A JAX TrainState (global-norm clip, cosine schedule) after two
    steps, carried into the port: the parameters and statistics through
    the weight map, Adam's moments, count and the step through
    `load_optax_state` (bit for bit); then one more step in each package
    on the same clouds and noise. DeepSets SetVAE, f32: the moments and
    parameters after it, relative to their max, measured 3.5e-6 (mu),
    5.2e-6 (nu), 2.2e-6 (parameters); bound 5e-5. The pre-BatchNorm
    biases, whose gradient is roundoff, are held only to 2 lr (Adam
    moves each by about lr a step)."""
    jmodel, variables, port = _pair("setvae", DEEPSETS)
    tx = jax_state.make_optimizer(lr=LR, total_steps=10, grad_clip=CLIP)
    state = jax_state.TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                        jax.tree.map(jnp.asarray, variables["batch_stats"]),
                                        tx)
    xs, epss = zip(*(_data(seed=10 + i) for i in range(3)))

    def step(state, i):
        # a new jitted step for each eps: a traced step keeps the eps it
        # was traced with
        monkeypatch.undo()
        patch_eps(monkeypatch, epss[i])
        return jax_make_train_step(jmodel, tx)(state, jnp.asarray(xs[i]), WU_ALPHA,
                                               jax.random.PRNGKey(i))[0]

    for i in range(2):
        state = step(state, i)
    opt_state = to_np(serialization.to_state_dict(state.opt_state))

    weights.load_flax_params(port, to_np(state.params), to_np(state.batch_stats))
    ts = TrainState(port, make_optimizer(port.parameters(), lr=LR, total_steps=10,
                                         grad_clip=CLIP))
    load_optax_state(ts, opt_state, int(state.step))
    assert ts.step == 2 and ts.optimizer.count == 2
    keys = [k for k, _ in port.named_parameters()]
    adam = opt_state["1"]["0"]
    for name in ("mu", "nu"):
        want = weights.params_to_state_dict(adam[name], keys)
        for k, v in adam_state(ts)[name].items():
            assert torch.equal(v, want[k]), (name, k)

    state = step(state, 2)
    make_train_step(port, ts.optimizer)(torch.from_numpy(xs[2]), torch.from_numpy(epss[2]),
                                        WU_ALPHA)
    after = to_np(serialization.to_state_dict(state.opt_state))["1"]["0"]
    skip = pre_batchnorm_biases(keys)
    for name, want_tree, got in (("mu", after["mu"], adam_state(ts)["mu"]),
                                 ("nu", after["nu"], adam_state(ts)["nu"]),
                                 ("params", to_np(state.params), dict(port.named_parameters()))):
        want = weights.params_to_state_dict(want_tree, keys)
        for k in keys:
            err = float((got[k].detach() - want[k]).abs().max())
            if k in skip:
                assert name != "params" or err <= 2 * LR, (name, k, err)
            else:
                assert err <= 5e-5 * max(1e-12, float(want[k].abs().max())), (name, k, err)
    assert ts.optimizer.count == int(after["count"]) == 3


# ---------------------------------------------------------------- checkpoints


def _state(mp=DEEPSETS, seed=0, steps=1):
    """A port TrainState after `steps` train steps (moments, count and
    statistics away from their initial values)."""
    model = build_model("setlrvae", "shapenet", mp, beta=BETA, alpha=ALPHA,
                        generator=torch.Generator().manual_seed(seed))
    ts = TrainState(model, make_optimizer(model.parameters(), lr=LR, total_steps=10,
                                          grad_clip=CLIP))
    step = make_train_step(model, ts.optimizer)
    for i in range(steps):
        x, eps = _data(seed=20 + i)
        step(torch.from_numpy(x), torch.from_numpy(eps), WU_ALPHA)
        ts.step += 1
    return ts


def _assert_same_state(a, b):
    for (k, v), w in zip(a.model.state_dict().items(), b.model.state_dict().values()):
        assert torch.equal(v, w), k
    for name in ("mu", "nu"):
        for k, v in adam_state(a)[name].items():
            assert torch.equal(v, adam_state(b)[name][k]), (name, k)
    assert (a.optimizer.count, a.step) == (b.optimizer.count, b.step)


def test_checkpoint_round_trip(tmp_path):
    ts = _state(steps=2)
    path = str(tmp_path / "params" / "ckpt_3.pkl")
    checkpoint.save_checkpoint(path, ts, epoch=3, extra={"wu_alpha": 0.25, "last_kl": 1.5})
    assert not os.path.exists(path + ".tmp")
    fresh = _state(seed=9, steps=0)
    restored, epoch, extra = checkpoint.load_checkpoint(path, fresh)
    assert restored is fresh and epoch == 3 and extra == {"wu_alpha": 0.25, "last_kl": 1.5}
    _assert_same_state(ts, fresh)
    # the optimizer state is stored in optax's ScaleByAdamState layout
    with open(path, "rb") as f:
        payload = pickle.load(f)
    assert set(payload["opt_state"]) == {"count", "mu", "nu"}
    assert payload["opt_state"]["mu"].keys() == payload["params"].keys()


def test_async_checkpointer_round_trip(tmp_path):
    ts = _state()
    path = str(tmp_path / "ck_async.pkl")
    acp = checkpoint.AsyncCheckpointer()
    acp.submit(path, ts, epoch=5, extra={"wu_alpha": 0.25})
    acp.close()
    fresh = _state(seed=9, steps=0)
    _, epoch, extra = checkpoint.load_checkpoint(path, fresh)
    assert epoch == 5 and extra["wu_alpha"] == 0.25
    _assert_same_state(ts, fresh)


def test_async_checkpointer_snapshots_at_submit(tmp_path):
    """submit() copies the state before it returns: the in-place optimizer
    step that follows cannot reach the queued snapshot."""
    ts = _state()
    want = {k: v.clone() for k, v in ts.model.state_dict().items()}
    want_mu = {k: v.clone() for k, v in adam_state(ts)["mu"].items()}
    path = str(tmp_path / "ck_snap.pkl")
    acp = checkpoint.AsyncCheckpointer()
    acp.submit(path, ts, epoch=0)
    x, eps = _data(seed=30)
    make_train_step(ts.model, ts.optimizer)(torch.from_numpy(x), torch.from_numpy(eps))
    acp.close()
    fresh = _state(seed=9, steps=0)
    checkpoint.load_checkpoint(path, fresh)
    for k, v in fresh.model.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert any(not torch.equal(v, want[k]) for k, v in ts.model.state_dict().items())
    for k, v in adam_state(fresh)["mu"].items():
        assert torch.equal(v, want_mu[k]), k


def test_async_checkpointer_error_surfaces(tmp_path):
    acp = checkpoint.AsyncCheckpointer()
    acp.submit(str(tmp_path / "missing") + "/x/\0bad", _state(steps=0))
    with pytest.raises(ValueError):
        acp.wait()
    with pytest.raises(ValueError):
        acp.close()
    assert not acp._worker.is_alive()


def test_async_checkpointer_submit_survives_prior_error(tmp_path, capsys):
    """A failed periodic write does not stop the next submit: it warns
    once and writes; close() still raises the first error."""
    ts = _state(steps=0)
    acp = checkpoint.AsyncCheckpointer()
    acp.submit(str(tmp_path / "missing") + "/x/\0bad", ts)
    acp._q.join()
    good = tmp_path / "good.pkl"
    acp.submit(str(good), ts)
    acp.submit(str(tmp_path / "good2.pkl"), ts)
    assert capsys.readouterr().err.count("async checkpoint write failed") == 1
    with pytest.raises(ValueError):
        acp.close()
    assert good.exists() and not acp._worker.is_alive()


# train_and_test runs: smaller clouds and widths than the step tests
RUN_POINTS = 64
RUN_ATTN = dict(ATTN, num_points=RUN_POINTS, d_model=64, ff_dim=32)
RUN_DEEPSETS = dict(DEEPSETS, num_points=RUN_POINTS)


def _trainer_kw(tmp_path, **kw):
    return dict(epochs=3, batch_size=8, dataset_name="shapenet", seed=5, lr=LR,
                grad_clip=CLIP, wu_strat="kl_adaptive", device="cpu",
                dataset_params={"fake": True, "num_points": RUN_POINTS, "num_samples": 16,
                                "num_test_samples": 8},
                output_root=str(tmp_path), **kw)


def _ckpts(root):
    return sorted(os.path.join(r, f) for r, _d, fs in os.walk(root) for f in fs
                  if f.startswith("ckpt_"))


# The resume runs (test_resume_replays_the_continuous_run and
# test_resume_without_warmup_state_replays_the_schedule) live in
# tests/test_torch_trainer_resume.py, so that pytest-xdist's --dist
# loadfile puts them on another worker; they import the helpers above.


def test_async_checkpoint_write_failure_warns_and_keeps_the_state(tmp_path, monkeypatch, capsys):
    """A failing async write warns at the end of train_and_test, which
    still returns its trained state and writes its export."""
    def fail(path, snap, epoch, extra):
        raise OSError("disk full")

    monkeypatch.setattr(checkpoint, "_write", fail)
    model = build_model("setvae", "shapenet", RUN_ATTN,
                        generator=torch.Generator().manual_seed(0))
    state, summary = train_and_test(model, checkpoint_every=1, async_checkpoint=True,
                                    **_trainer_kw(tmp_path))
    assert state.step == 6 and os.listdir(os.path.join(summary["result_dir"], "params")) == [
        "model_2.pkl"]
    assert "async checkpoint write failed" in capsys.readouterr().err


def test_cli_refuses_resume_for_a_sweep(tmp_path):
    """As the JAX CLI: one checkpoint cannot seed every cell of a sweep."""
    common = {"niter": 1, "exp_epochs": 1, "batch_size": 8, "exp_data": "shapenet",
              "dataset_params": {"num_points": N, "num_samples": 16}}
    mp = dict(ATTN, beta_list=[0.001, 0.01])
    cfg = tmp_path / "sweep.yaml"
    cfg.write_text(yaml.safe_dump({"experiment_type": "setvae", "common_params": common,
                                   "model_params": mp}))
    with pytest.raises(ValueError, match="2-point sweep"):
        cli_main.main(["--config", str(cfg), "--fake_data", "--device", "cpu",
                       "--resume_from", str(tmp_path / "ckpt_0.pkl"),
                       "--output_root", str(tmp_path)])


# ---------------------------------------------------------------- use_cosine, progress, artifacts


def test_constant_lr_without_cosine_matches_jax(one_thread, tmp_path, monkeypatch):
    """`use_cosine=False` builds the optimizer without a schedule, as JAX
    (train/loop.py:267, `total_steps=None`): the learning rate stays at
    `lr` through a run, and three updates of the chained clip + Adam at a
    constant rate on fixed gradients match optax's to two f32 ulps (the
    bound of tests/test_torch_train.py's cosine case)."""
    from vae_song_tpu_torch.train import loop

    built = []
    make = loop.make_optimizer
    monkeypatch.setattr(loop, "make_optimizer", lambda *a, **k: built.append(k) or make(*a, **k))
    state, _ = train_and_test(build_model("setvae", "shapenet", RUN_ATTN), use_cosine=False,
                              **dict(_trainer_kw(tmp_path, visualize_artifacts=False), epochs=1))
    assert built[0]["total_steps"] is None and state.optimizer.lr() == LR

    rng = np.random.default_rng(9)
    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 3), (7,))]
    tx = jax_state.make_optimizer(lr=LR, total_steps=None, grad_clip=CLIP)
    tree = {f"p{i}": jnp.zeros(g.shape) for i, g in enumerate(grads)}
    opt_state = tx.init(tree)
    for _ in range(3):
        upd, opt_state = tx.update({f"p{i}": jnp.asarray(g) for i, g in enumerate(grads)},
                                   opt_state, tree)
        tree = optax.apply_updates(tree, upd)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    opt = make_optimizer(params, lr=LR, total_steps=None, grad_clip=CLIP)
    for _ in range(3):
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(tree[f"p{i}"]),
                                   rtol=2.5e-7, atol=0)


def _tree(root):
    """The files a run wrote under results/, by path below the run's
    directory, the run's name (which carries the minute it started) in
    them replaced by RUN."""
    out = set()
    for r, _d, fs in os.walk(os.path.join(root, "results")):
        parts = os.path.relpath(r, root).split(os.sep)
        if len(parts) < 3:
            continue
        out.update("/".join(parts[3:] + [f]).replace(parts[2], "RUN") for f in fs)
    return out


@pytest.mark.parametrize("visualize", [True, False])
def test_progress_and_artifacts_as_jax(one_thread, tmp_path, capsys, visualize):
    """`progress=False` prints no progress line, `visualize_artifacts`
    writes the point-cloud dumps or none of them (JAX train/loop.py:977,
    :999-1004): the port and the JAX trainer write the same files under
    results/ for the same options (the log and the exported parameters
    either way)."""
    mp = dict(latent_channel=4, num_points=16, d_model=16, num_heads=2, ff_dim=32)
    kw = dict(epochs=1, batch_size=8, dataset_name="shapenet", seed=0,
              dataset_params={"fake": True, "num_points": 16, "num_samples": 16},
              visualize_artifacts=visualize, progress=False)
    jax_train_and_test(jax_build_model("setvae", "shapenet", mp),
                       output_root=str(tmp_path / "jax"), **kw)
    capsys.readouterr()
    train_and_test(build_model("setvae", "shapenet", mp), output_root=str(tmp_path / "port"),
                   device="cpu", **kw)
    assert "epoch 0" not in capsys.readouterr().out
    got, want = _tree(str(tmp_path / "port")), _tree(str(tmp_path / "jax"))
    assert got == want
    assert any(f.startswith("point_clouds/") for f in got) == visualize
