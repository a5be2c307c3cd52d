"""The DeepSets SetVAE / SetLRVAE (`use_attention: false`: per-point
Dense -> BatchNorm -> ReLU, pooling, a query-MLP decoder) in the port
against the JAX package on the CPU, with the same weights (through
vae_song_tpu_torch.weights), the same BatchNorm statistics, clouds and
noise: BatchNorm alone, the forward in train and eval mode, one train
step (loss terms, parameter gradients, updated parameters, the running
statistics, SetLRVAE's two updates of the encoder's a step included),
the weight map and the parameter exports in both directions. Both
packages run f32 here (the DeepSets models take no compute dtype) and
the exact tiled Chamfer. Every bound sits beside the difference it was
set from.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.nn.blocks import BatchNorm as JaxBatchNorm
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.loop import init_model
from vae_song_tpu.train.steps import make_apply_fns as jax_apply_fns
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.blocks import BatchNorm, pre_batchnorm_biases
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_train_step

from jax_parity import grads_capture, patch_eps, to_np

B, N, LATENT = 4, 128, 16
MODEL_PARAMS = dict(latent_channel=LATENT, num_points=N, use_attention=False,
                    encoder_hidden=[32, 64], decoder_hidden=[64, 32])
BETA, ALPHA, WU_ALPHA, LR = 0.001, 0.5, 0.3, 1e-2


def _random_stats(bs, seed):
    """Running statistics away from their initial 0 / 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else rng.normal(size=a.shape)).astype(np.float32), to_np(bs))


def _pair(kind, seed=0, mp=None):
    """The JAX model and its initial variables (running statistics made
    random), and the port model holding the same."""
    mp = dict(MODEL_PARAMS, **(mp or {}))
    jmodel = jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    params, bs = init_model(jmodel, np.zeros((2, N, 3), np.float32), seed=seed)
    params, bs = to_np(params), _random_stats(bs, seed + 1)
    port = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    weights.load_flax_params(port, params, bs)
    return jmodel, params, bs, port


def _data(seed=2):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    eps = rng.normal(size=(B, LATENT)).astype(np.float32)
    return x, eps


def _stats_of(port):
    return weights.state_dict_to_variables(port.state_dict())["batch_stats"]


def _max_rel(got_tree, want_tree):
    """Largest |got - want| / max(1, max|want|) over matching leaves."""
    got = dict(jax.tree_util.tree_flatten_with_path(got_tree)[0])
    want = dict(jax.tree_util.tree_flatten_with_path(to_np(want_tree))[0])
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max()) / max(1.0, float(np.abs(want[k]).max()))
               for k in want)


# ---------------------------------------------------------------- BatchNorm


# Train mode: the same f32 statistics summed in other orders (measured
# 9.5e-7 on the output at max 7.7, 1.2e-7 on the running statistics);
# eval mode: the same arithmetic (measured 1.9e-6 at max 18.6). Bound
# 2e-6 of max(1, max|want|) on the output, 2e-6 on the statistics.
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("shape", [(4, 128, 24), (6, 24)])
def test_batchnorm_matches_flax(train, shape):
    """Flax semantics, not torch's: statistics over every axis but the
    last, E[x^2] - E[x]^2, and the BIASED batch variance in the running
    average 0.9 * running + 0.1 * batch."""
    rng = np.random.default_rng(3)
    x = (rng.normal(size=shape) * 2.0 + 0.5).astype(np.float32)
    bn = JaxBatchNorm()
    variables = to_np(bn.init(jax.random.PRNGKey(0), x, False))
    c = shape[-1]
    variables["params"]["BatchNorm_0"] = {"scale": rng.normal(size=c).astype(np.float32),
                                          "bias": rng.normal(size=c).astype(np.float32)}
    variables["batch_stats"] = _random_stats(variables["batch_stats"], 4)
    want, new = bn.apply(variables, x, train, mutable=["batch_stats"])
    port = BatchNorm(c)
    leaves = variables["params"]["BatchNorm_0"] | variables["batch_stats"]["BatchNorm_0"]
    port.load_state_dict({"weight": torch.tensor(leaves["scale"]),
                          "bias": torch.tensor(leaves["bias"]),
                          "running_mean": torch.tensor(leaves["mean"]),
                          "running_var": torch.tensor(leaves["var"])})
    got = port.train(train)(torch.from_numpy(x))
    want = np.asarray(want)
    assert got.dtype == torch.float32
    tol = 2e-6 * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=tol, rtol=0)
    for name, leaf in (("running_mean", "mean"), ("running_var", "var")):
        w = np.asarray(new["batch_stats"]["BatchNorm_0"][leaf])
        np.testing.assert_allclose(getattr(port, name).numpy(), w, atol=2e-6, rtol=0)
    if train:
        unbiased = np.var(x.reshape(-1, c), axis=0, ddof=1)
        biased = np.var(x.reshape(-1, c), axis=0)
        ra = 0.9 * leaves["var"] + 0.1 * biased
        np.testing.assert_allclose(port.running_var.numpy(), ra, rtol=1e-5)
        assert not np.allclose(port.running_var.numpy(), 0.9 * leaves["var"] + 0.1 * unbiased,
                               rtol=1e-5, atol=0)


# ---------------------------------------------------------------- forward


def _jax_forward(jmodel, params, bs, x, train):
    outs, new = jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x), train=train,
                             rngs={"sampling": jax.random.PRNGKey(0)},
                             mutable=["batch_stats"])
    return outs, new["batch_stats"]


# Train and eval mode, f32 on both sides, relative to max(1, max|want|):
# max and mean pooling measured up to 7.5e-6 (SetLRVAE's z_recon, train
# mode) and 3.4e-7 on the running statistics; sum pooling adds 128
# points into logvar ~ 84, so z reaches 1e18 and the decoder's inputs
# with it: measured 6.3e-5 on z_recon and 1.3e-5 on the statistics.
# Bound 1e-4.
@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("pool", ["max", "mean", "sum"])
def test_forward_matches_jax(monkeypatch, kind, train, pool):
    jmodel, params, bs, port = _pair(kind, mp={"pool_type": pool})
    x, eps = _data()
    patch_eps(monkeypatch, eps)
    outs, want_bs = _jax_forward(jmodel, params, bs, x, train)
    port.train(train)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(eps))
    for name, g, w in zip(("recon", "mu", "logvar", "z", "z_recon"), got, outs):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w)
        assert g.dtype == torch.float32 and g.shape == w.shape, name
        tol = 1e-4 * max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=tol, rtol=0, err_msg=name)
    # train mode moves the statistics (SetLRVAE's encoder twice), eval
    # mode leaves them
    assert _max_rel(_stats_of(port), want_bs) <= 1e-4
    if not train:
        assert _max_rel(_stats_of(port), bs) == 0.0


def test_mixed_precision_leaves_the_deepsets_models_in_f32():
    """JAX passes the DeepSets models no compute dtype: the flag changes
    nothing."""
    a = build_model("setvae", "shapenet", dict(MODEL_PARAMS, mixed_precision=True),
                    generator=torch.Generator().manual_seed(1))
    b = build_model("setvae", "shapenet", MODEL_PARAMS,
                    generator=torch.Generator().manual_seed(1))
    x, eps = _data()
    _, _, fa = make_apply_fns(a)
    _, _, fb = make_apply_fns(b)
    for ga, gb in zip(fa(torch.from_numpy(x), torch.from_numpy(eps))[:4],
                      fb(torch.from_numpy(x), torch.from_numpy(eps))[:4]):
        assert ga.dtype == torch.float32 and torch.equal(ga, gb)


# ---------------------------------------------------------------- train step


# One train step from the same weights and statistics on the same clouds
# and noise, f32. The hidden Dense layers' biases feed a BatchNorm, which
# subtracts the batch mean: their gradient is zero analytically, and
# both sides compute roundoff (up to 1e-5 here), which Adam's first
# update (about lr * sign(g)) turns into +-lr. They are held to that
# size and left out of the rest. Measured setvae / setlrvae: 3.7e-7 /
# 6.5e-7 relative on the loss terms, 2.8e-6 / 8.4e-6 relative L2 on the
# parameter gradients (the queries and BatchNorm's scale and bias
# included), 5.0e-5 / 5.0e-5 of the updated elements apart by more than
# lr/100 (one element of the queries), 9.7e-8 / 1.9e-7 on the running
# statistics. Bounds 1e-5, 1e-4, 1e-3 and 1e-5.
@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_train_step_matches_jax(monkeypatch, kind):
    jmodel, params, bs, port = _pair(kind)
    x, eps = _data()
    patch_eps(monkeypatch, eps)
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=LR))
    state = jax_state.TrainState.create(params, bs, tx)
    state, jm = jax_make_train_step(jmodel, tx)(state, jnp.asarray(x), WU_ALPHA,
                                                jax.random.PRNGKey(0))
    keys = [k for k, _ in port.named_parameters()]
    j_grads = weights.params_to_state_dict(to_np(state.opt_state[0]), keys)
    j_after = weights.params_to_state_dict(to_np(state.params), keys)

    # SetLRVAE moves the encoder's statistics twice: encode(x), then
    # encode(recon); the decoder's once
    enc_before = port.encoder.norm[0].running_mean.clone()
    with torch.no_grad():
        h = port.encoder.dense[0](torch.from_numpy(x)).reshape(-1, MODEL_PARAMS["encoder_hidden"][0])
    pm = make_train_step(port, make_optimizer(port.parameters(), lr=LR))(
        torch.from_numpy(x), torch.from_numpy(eps), WU_ALPHA)
    rel = max(abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-6)
              for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    before_bn = pre_batchnorm_biases(keys)
    assert len(before_bn) == len(port.encoder.norm) + len(port.decoder.norm)
    scale = max(float(g.abs().max()) for g in grads.values())
    assert all(float(grads[k].abs().max()) <= 1e-4 * scale for k in before_bn)
    live = [k for k in keys if k not in before_bn]
    num = sum(float(((grads[k] - j_grads[k]) ** 2).sum()) for k in live)
    den = sum(float((j_grads[k] ** 2).sum()) for k in live)
    after = dict(port.named_parameters())
    share = float(torch.cat([(after[k].detach() - j_after[k]).abs().reshape(-1)
                             for k in live]).gt(LR / 100).float().mean())
    stats = _max_rel(_stats_of(port), state.batch_stats)
    diffs = (rel, (num / den) ** 0.5, share, stats)
    assert all(d <= b for d, b in zip(diffs, (1e-5, 1e-4, 1e-3, 1e-5))), diffs
    # the encoder's first running mean after one update, by hand
    once = 0.9 * enc_before + 0.1 * h.mean(0)
    if kind == "setvae":
        np.testing.assert_allclose(port.encoder.norm[0].running_mean.numpy(), once.numpy(),
                                   rtol=0, atol=1e-5)
    else:
        assert not np.allclose(port.encoder.norm[0].running_mean.numpy(), once.numpy(),
                               rtol=0, atol=1e-3)


# ---------------------------------------------------------------- the weight map


def test_weight_map_round_trip_with_statistics():
    """JAX variables -> port -> JAX variables, bit for bit, the BatchNorm
    `batch_stats` with the params; every leaf has a port counterpart."""
    _, params, bs, port = _pair("setlrvae", seed=5)
    back = weights.state_dict_to_variables(port.state_dict())
    for got, want in ((back["params"], params), (back["batch_stats"], bs)):
        a = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        b = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    assert port.encoder.norm[1].running_var.shape == (MODEL_PARAMS["encoder_hidden"][1],)
    with pytest.raises(RuntimeError):
        weights.load_flax_params(port, params)          # statistics missing


def test_params_only_exports_cross_both_ways(tmp_path, monkeypatch):
    """A port export of a trained DeepSets model (statistics moved) loads
    into the JAX package and decodes the port's clouds; a JAX export
    loads into the port bit for bit."""
    jmodel, _, bs, port = _pair("setvae", seed=6)
    x, eps = _data(seed=7)
    make_train_step(port, make_optimizer(port.parameters(), lr=LR))(
        torch.from_numpy(x), torch.from_numpy(eps))
    path = str(tmp_path / "port" / "model_0.pkl")
    checkpoint.save_params_only(path, port)
    template = jax.eval_shape(lambda a: init_model(jmodel, a),
                              np.zeros((2, N, 3), np.float32))
    params, got_bs = jax_ckpt.load_params_only(path, template[0], template[1])
    assert _max_rel(_stats_of(port), got_bs) == 0.0 and _max_rel(bs, got_bs) > 0.0
    z = np.random.default_rng(8).normal(size=(3, LATENT)).astype(np.float32)
    _, jax_decode, _ = jax_apply_fns(jmodel)
    want = np.asarray(jax_decode(jax_state.TrainState.create(
        params, got_bs, jax_state.make_optimizer(lr=0.0)), jnp.asarray(z)))
    _, decode, _ = make_apply_fns(port)
    got = decode(torch.from_numpy(z)).numpy()
    # eval mode, f32 both sides: measured 2.4e-7 at max|cloud| 0.65
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)

    jpath = str(tmp_path / "jax" / "model_0.pkl")
    jax_ckpt.save_params_only(jpath, params, got_bs)
    fresh = checkpoint.load_params_only(jpath, build_model("setvae", "shapenet", MODEL_PARAMS))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
