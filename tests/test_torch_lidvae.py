"""LID-VAE in the port against the JAX package on the CPU: the ICNN blocks
(PositiveLinear, ICNN, LinearModuleEP), the LIDVAE encode, decode and
forward on carried-across weights (the MLP encoder on pinwheel points,
the conv encoder at MNIST's geometry with few channels), one train step
against JAX `make_train_step` (second-order gradients through the
Brenier decode included), the convexity and monotonicity properties of
JAX tests/test_models.py:79-106, the decode's graph outside training,
the `.pkl` exports both ways, and `run_experiment` on a pinwheel lidvae
config. Every bound sits beside the difference it was set from."""

import copy
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.models.lidvae import LIDVAE as JaxLIDVAE
from vae_song_tpu.models.lidvae import LIDVAE_DATASET_OVERRIDES as JAX_OVERRIDES
from vae_song_tpu.nn import blocks as jax_blocks
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.loop import init_model
from vae_song_tpu.train.steps import make_train_step as jax_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.cli.main import run_experiment
from vae_song_tpu_torch.models.lidvae import LIDVAE, LIDVAE_DATASET_OVERRIDES
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn import blocks
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step, make_train_step

from jax_parity import (grad_gap, grads_capture, max_rel, one_thread, patch_eps,  # noqa: F401
                        random_stats, rel_err, to_np)

pytestmark = pytest.mark.usefixtures("one_thread")

B = 16
# (dataset, hidden_channels, icnn_channels): the MLP encoder on 1-D points,
# and the conv encoder on 28 x 28 x 1 images (latent 32, icnn2 on 784 inputs)
ARCHS = {"mlp": ("pinwheel", (8, 8, 2), (16, 32)), "conv": ("mnist", (4, 8), (16, 32))}
IL = 0.3


def _inputs(dataset, batch, seed):
    rng = np.random.default_rng(seed)
    if dataset == "pinwheel":
        return rng.normal(size=(batch, 2)).astype(np.float32)
    return rng.random((batch, 28, 28, 1)).astype(np.float32)


@functools.lru_cache
def _initial_variables(arch):
    """JAX's initial variables of `arch` (init jitted: eagerly it takes
    seconds), the running statistics made random."""
    dataset, hidden, icnn = ARCHS[arch]
    jmodel = JaxLIDVAE.for_dataset(dataset, hidden_channels=hidden, icnn_channels=icnn)
    params, bs = jax.jit(lambda x: init_model(jmodel, x, seed=0))(_inputs(dataset, 2, 0))
    return to_np(params), random_stats(bs, 1)


def _pair(arch, beta=0.5):
    """The JAX LIDVAE of `arch` with its initial variables and the port
    model holding the same."""
    dataset, hidden, icnn = ARCHS[arch]
    kw = dict(hidden_channels=hidden, icnn_channels=icnn, inverse_lipschitz=IL, beta=beta)
    jmodel = JaxLIDVAE.for_dataset(dataset, **kw)
    params, bs = copy.deepcopy(_initial_variables(arch))
    port = LIDVAE.for_dataset(dataset, **kw)
    weights.load_flax_params(port, params, bs)
    return jmodel, params, bs, port


# ---------------------------------------------------------------- the blocks


class _Holder(torch.nn.Module):
    def __init__(self, icnn):
        super().__init__()
        self.icnn1 = icnn


def _dense_leaves(port_dense, flax_tree, names):
    """Carry Flax Dense_i (kernel [in, out], bias) into the port's Dense list."""
    with torch.no_grad():
        for layer, name in zip(port_dense, names):
            layer.weight.copy_(torch.tensor(np.asarray(flax_tree[name]["Dense_0"]["kernel"]).T))
            layer.bias.copy_(torch.tensor(np.asarray(flax_tree[name]["Dense_0"]["bias"])))


@pytest.mark.parametrize("kind", ["positive_exp", "positive_clamp", "icnn", "icnn3", "linear_ep"])
def test_icnn_blocks_match_flax(kind):
    """Outputs on the same weights and inputs, f32: measured up to 1.5e-7
    relative to the output's largest magnitude; bound 1e-5."""
    key = jax.random.PRNGKey(3)
    x = np.random.default_rng(4).normal(size=(32, 6)).astype(np.float32)
    if kind.startswith("positive"):
        is_exp = kind == "positive_exp"
        jm = jax_blocks.PositiveLinear(12, is_exp=is_exp)
        params = jm.init(key, x)["params"]
        port = blocks.PositiveLinear(6, 12, is_exp=is_exp)
        with torch.no_grad():
            port.weight.copy_(torch.tensor(np.asarray(params["kernel"]).T))
    elif kind.startswith("icnn"):
        layers = 3 if kind == "icnn3" else 2
        jm = jax_blocks.ICNN(16, num_layers=layers)
        params = jm.init(key, x)["params"]
        port = blocks.ICNN(6, 16, num_layers=layers)
        # through the weight map's ICNN rules
        holder = _Holder(port)
        holder.load_state_dict(weights.params_to_state_dict(
            {"icnn1": to_np(params)}, holder.state_dict().keys()))
    else:
        jm = jax_blocks.LinearModuleEP(16)
        params = jm.init(key, x)["params"]
        port = blocks.LinearModuleEP(6, 16)
        _dense_leaves(port.dense, params, [f"Dense_{i}" for i in range(5)])
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    assert rel_err(got, want) < 1e-5


def test_icnn_convexity():
    """f(t x + (1 - t) y) <= t f(x) + (1 - t) f(y) (JAX test_models.py:79)."""
    gen = torch.Generator().manual_seed(0)
    icnn = blocks.ICNN(2, 16, generator=gen)
    x, y = torch.randn(32, 2, generator=gen), torch.randn(32, 2, generator=gen)
    with torch.no_grad():
        for t in (0.25, 0.5, 0.75):
            lhs = icnn(t * x + (1 - t) * y)
            rhs = t * icnn(x) + (1 - t) * icnn(y)
            assert bool((lhs <= rhs + 1e-5 * rhs.abs().clamp(min=1)).all())


def test_lidvae_brenier_monotone():
    """<T(z1) - T(z2), z1 - z2> >= 0 for the gradient of a convex
    potential (JAX test_models.py:92)."""
    port = LIDVAE.for_dataset("pinwheel", hidden_channels=(8, 8, 2), icnn_channels=(16, 16),
                              generator=torch.Generator().manual_seed(1))
    gen = torch.Generator().manual_seed(2)
    z1, z2 = torch.randn(64, 2, generator=gen), torch.randn(64, 2, generator=gen)
    _, decode, _ = make_apply_fns(port)
    inner = ((decode(z1) - decode(z2)) * (z1 - z2)).sum(dim=1)
    assert bool((inner >= -1e-4 * inner.abs().max()).all())


# ---------------------------------------------------------------- the model


def test_dataset_overrides_and_defaults_match_jax():
    assert LIDVAE_DATASET_OVERRIDES == JAX_OVERRIDES
    for ds in ("pinwheel", "mnist", "celeba", "omniglot"):
        for hidden in (None, (4, 4)):
            j, p = JaxLIDVAE.for_dataset(ds, hidden_channels=hidden), LIDVAE.for_dataset(
                ds, hidden_channels=hidden, icnn_channels=(4, 4))
            for attr in ("in_channel", "latent_channel", "hidden_channels", "input_dim",
                         "data_type", "grad_mode"):
                assert getattr(p, attr) == getattr(j, attr), (ds, attr)


# JAX's jitted f32 conv forward on the CPU lands 4.5e-5 to 1.1e-4 from a
# float64 run of the same weights, the port's 1.2e-6 to 4.2e-6: the conv
# outputs are held to the port's float64 copy at F64_BOUND and to JAX at
# the JAX side's own error
F64_BOUND = 1e-5
JAX_BOUND = {"mlp": 1e-5, "conv": 5e-4}
# the train step's loss terms from JAX's: JAX's f32 conv again the noisier
TERMS_BOUND = {"mlp": 1e-5, "conv": 1e-4}
GRAD_BOUND = {"mlp": 5e-5, "conv": 5e-3}


def _f64(port):
    ref = copy.deepcopy(port).double()
    return ref


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_lidvae_forward_matches_jax(monkeypatch, arch):
    """encode, decode, and the forward in eval and train mode (the
    BatchNorm statistics it moves too) on the same weights and eps, JAX
    jitted. Each output is held to the port's float64 copy (F64_BOUND;
    measured up to 1.4e-6 MLP, 4.2e-6 conv) and to JAX (JAX_BOUND;
    measured up to 2.9e-6 MLP, 1.1e-4 conv), relative to the output's
    largest magnitude; the statistics 1.1e-7 and 2.1e-6 (bound 1e-5)."""
    jmodel, params, bs, port = _pair(arch)
    dataset = ARCHS[arch][0]
    x = _inputs(dataset, B, 5)
    eps = np.random.default_rng(6).normal(size=(B, port.latent_channel)).astype(np.float32)
    patch_eps(monkeypatch, eps)
    variables = {"params": params, "batch_stats": bs}
    xt, ref = torch.from_numpy(x), _f64(port)
    encode, decode, forward = make_apply_fns(port)
    enc64, dec64, fwd64 = make_apply_fns(ref)

    def check(got, want, got64):
        for g, w, r in zip(got, want, got64):
            assert g.shape == w.shape and not g.requires_grad
            assert rel_err(g.double(), r.detach().numpy()) < F64_BOUND
            assert rel_err(g, w) < JAX_BOUND[arch]

    rngs = {"sampling": jax.random.PRNGKey(0)}

    @jax.jit
    def jax_outputs(v, a):
        """encode, decode of mu + 0.5, eval forward, train forward: one jit."""
        mu_lv = jmodel.apply(v, a, method="encode")
        z = mu_lv[0] + 0.5
        return (mu_lv, z, jmodel.apply(v, z, method="decode"),
                jmodel.apply(v, a, train=False, rngs=rngs),
                jmodel.apply(v, a, train=True, rngs=rngs, mutable=["batch_stats"]))

    mu_lv, z, dec, want_eval, (want_train, mut) = jax_outputs(variables, jnp.asarray(x))
    check(encode(xt), mu_lv, enc64(xt.double()))
    z = torch.from_numpy(np.array(z))
    check([decode(z)], [dec], [dec64(z.double())])
    got = forward(xt, torch.from_numpy(eps)[None])
    assert got[4] is None and want_eval[4] is None
    check(got[:4], want_eval[:4], fwd64(xt.double(), torch.from_numpy(eps).double()[None])[:4])

    port.train()
    ref.train()
    got = [t.detach() for t in port(xt, torch.from_numpy(eps))[:4]]
    check(got, want_train[:4], ref(xt.double(), torch.from_numpy(eps).double())[:4])
    stats = weights.state_dict_to_variables(port.state_dict())["batch_stats"]
    assert max_rel(stats, mut["batch_stats"]) < 1e-5


def test_lidvae_forward_takes_one_sample():
    port = LIDVAE.for_dataset("pinwheel", hidden_channels=(8, 2), icnn_channels=(8, 8))
    x = torch.randn(4, 2)
    with pytest.raises(ValueError, match="one latent sample"):
        port(x, torch.randn(2, 4, 2))
    a, b = port(x, torch.ones(1, 4, 2)), port(x, torch.ones(4, 2))
    assert torch.equal(a[0], b[0])


def _step_jax(jmodel, params, bs, x, lr):
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=lr))
    state = jax_state.TrainState.create(params, bs, tx)
    state, m = jax_train_step(jmodel, tx)(state, jnp.asarray(x), 0.3, jax.random.PRNGKey(0))
    return {k: float(v) for k, v in m.items()}, to_np(state.opt_state[0]), to_np(state.params), \
        to_np(state.batch_stats)


@pytest.mark.parametrize("arch", ["mlp", "conv"])
def test_lidvae_train_step_matches_jax(monkeypatch, arch):
    """One train step (composite gradient through the second-order
    Brenier decode, Adam at lr 1e-3) from the same weights, statistics,
    inputs and eps, against JAX make_train_step (jitted) and against a
    float64 copy of the port. Measured (MLP; conv), relative: loss terms
    from JAX 2.6e-7; 1.3e-5 (JAX's f32 conv: the port is 6.1e-7 from
    float64), gradient (relative L2) from JAX 8.8e-7; 1.1e-3 (JAX 1.1e-3
    from float64, the port 1.0e-6; 3.9e-6), parameters moved apart by more
    than lr/100 0; 8.2e-5 of the elements, statistics 7.8e-8; 4.5e-6.
    Bounds: TERMS_BOUND, GRAD_BOUND, 1e-5 loss terms and gradient from
    float64 (the port), 1e-3 moved share, 1e-5 statistics. Every ICNN weight gets a nonzero gradient in both packages
    (a decode without create_graph would give them none); the last
    layer's bias, whose gradient through a Brenier map is zero, is left
    out of that."""
    lr = 1e-3
    jmodel, params, bs, port = _pair(arch, beta=0.5)
    x = _inputs(ARCHS[arch][0], B, 7)
    eps = np.random.default_rng(8).normal(size=(B, port.latent_channel)).astype(np.float32)
    patch_eps(monkeypatch, eps)
    keys = [k for k, _ in port.named_parameters()]
    live = [k for k in keys if k not in pre_batchnorm_biases(keys)]
    jm, j_grads, j_after, j_stats = _step_jax(jmodel, params, bs, x, lr)
    j_grads = weights.params_to_state_dict(j_grads, keys)
    j_after = weights.params_to_state_dict(j_after, keys)

    ref = copy.deepcopy(port).double()
    rm = make_train_step(ref, make_optimizer(ref.parameters(), lr=lr))(
        torch.from_numpy(x).double(), torch.from_numpy(eps).double()[None], 0.3)
    pm = make_train_step(port, make_optimizer(port.parameters(), lr=lr))(
        torch.from_numpy(x), torch.from_numpy(eps)[None], 0.3)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    f64 = {k: p.grad for k, p in ref.named_parameters()}
    terms = ("loss", "recon", "reg", "lr", "raw_kl")
    after = dict(port.named_parameters())
    got = {
        "terms": max(abs(float(pm[k]) - jm[k]) / max(abs(jm[k]), 1e-6) for k in terms),
        "terms_f64": max(abs(float(pm[k]) - float(rm[k])) / max(abs(float(rm[k])), 1e-6)
                         for k in terms),
        "grad": grad_gap(grads, j_grads, live),
        "grad_f64": grad_gap({k: g.double() for k, g in grads.items()}, f64, live),
        "jax_grad_f64": grad_gap({k: g.double() for k, g in j_grads.items()}, f64, live),
        "share": float(torch.cat([(after[k].detach() - j_after[k]).abs().reshape(-1)
                                  for k in live]).gt(lr / 100).float().mean()),
        "stats": max_rel(weights.state_dict_to_variables(port.state_dict())["batch_stats"],
                         j_stats),
    }
    assert got["terms"] < TERMS_BOUND[arch] and got["terms_f64"] < 1e-5
    assert float(pm["lr"]) == 0.0 and float(pm["reg"]) == pytest.approx(jm["raw_kl"], rel=1e-5)
    assert got["grad"] < GRAD_BOUND[arch] and got["grad_f64"] < 1e-5
    assert got["share"] < 1e-3 and got["stats"] < 1e-5
    icnn = [k for k in keys if k.startswith("icnn") and (k.endswith("weight") or ".dense.0." in k)]
    for g in (grads, j_grads):
        assert len(icnn) == 12 and all(float(torch.as_tensor(g[k]).abs().sum()) > 0 for k in icnn)


def test_decode_outside_training_keeps_no_graph():
    """The eval step and the apply functions run LIDVAE's decode under
    torch.no_grad() (torch.inference_mode() refuses it) and hand back
    tensors with no graph; the train-mode decode keeps a second-order
    graph to the ICNN weights."""
    port = LIDVAE.for_dataset("pinwheel", hidden_channels=(8, 2), icnn_channels=(8, 8),
                              generator=torch.Generator().manual_seed(0))
    x, eps = torch.randn(8, 2), torch.randn(1, 8, 2)
    m = make_eval_step(port)(x, eps)
    assert all(torch.isfinite(v) and not v.requires_grad for v in m.values())
    encode, decode, forward = make_apply_fns(port)
    for t in (*encode(x), decode(torch.randn(8, 2)), *forward(x, eps)[:4]):
        assert t.grad_fn is None and not t.requires_grad
    with torch.inference_mode(), pytest.raises(RuntimeError):
        port.eval().decode(torch.randn(8, 2))
    port.train()
    recon = port.decode(torch.randn(8, 2))
    weights_ = [p for name, p in port.icnn1.named_parameters() if name.endswith("weight")]
    g = torch.autograd.grad(recon.sum(), weights_)
    assert all(float(t.abs().sum()) > 0 for t in g)


def test_pkl_export_round_trips_with_jax(tmp_path):
    """The port's params/model_*.pkl loads into the JAX LIDVAE and gives
    its decode; JAX's export loads into the port, every leaf equal."""
    jmodel, params, bs, port = _pair("mlp")
    path = str(tmp_path / "port.pkl")
    checkpoint.save_params_only(path, port)
    template = jax.eval_shape(lambda x: init_model(jmodel, x), np.zeros((2, 2), np.float32))
    jp, jbs = jax_ckpt.load_params_only(path, template[0], template[1])
    assert max_rel(jp, params) == 0.0 and max_rel(jbs, bs) == 0.0
    z = np.random.default_rng(9).normal(size=(16, 2)).astype(np.float32)
    want = jmodel.apply({"params": jp, "batch_stats": jbs}, jnp.asarray(z), method="decode")
    assert rel_err(make_apply_fns(port)[1](torch.from_numpy(z)), want) < 1e-5

    jpath = str(tmp_path / "jax.pkl")
    jax_ckpt.save_params_only(jpath, params, bs)
    fresh = checkpoint.load_params_only(jpath, LIDVAE.for_dataset(
        "pinwheel", hidden_channels=ARCHS["mlp"][1], icnn_channels=ARCHS["mlp"][2]))
    for k, v in port.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_registry_builds_lidvae_as_jax():
    mp = {"hchans": [8, 2], "log_mse": True}
    port = build_model("lidvae", "pinwheel", mp, beta=0.3, il=0.4)
    jm = jax_build_model("lidvae", "pinwheel", mp, beta=0.3, il=0.4)
    for attr in ("hidden_channels", "icnn_channels", "inverse_lipschitz", "beta", "is_log_mse",
                 "latent_channel", "data_type"):
        assert getattr(port, attr) == getattr(jm, attr), attr
    variables = jax.eval_shape(lambda x: init_model(jm, x), np.zeros((2, 2), np.float32))
    want = dict(jax.tree_util.tree_flatten_with_path(variables[0])[0])
    got = dict(jax.tree_util.tree_flatten_with_path(
        weights.state_dict_to_variables(port.state_dict())["params"])[0])
    assert {k: tuple(v.shape) for k, v in want.items()} == {k: v.shape for k, v in got.items()}


def test_run_experiment_trains_lidvae_on_pinwheel(tmp_path):
    """A pinwheel config with experiment_type lidvae and an il_list: both
    sweep points train, evaluate and write their tree; the run name
    carries il / 2 as JAX's does."""
    config = {
        "experiment_type": "lidvae",
        "common_params": {"exp_data": "pinwheel", "exp_epochs": 1, "batch_size": 2500,
                          "niter": 1, "logfilename": None, "resultname": None,
                          "dataset_params": {"seed": 0}},
        "model_params": {"beta_list": [0.1], "il_list": [0.0, 0.2], "hchans": [8, 2]},
    }
    summaries = run_experiment(config, output_root=str(tmp_path), seed=1, device="cpu")
    assert [s["name"].split("_il=")[1] for s in summaries] == ["0.0", "0.1"]
    for s in summaries:
        assert s["name"].startswith("LIDVAE")
        assert all(np.isfinite(v) for v in s["eval"].values())
        assert all(np.isfinite(v) for v in s["posterior_metrics"].values())
        assert os.listdir(os.path.join(s["result_dir"], "params")) == ["model_0.pkl"]
    assert len(os.listdir(tmp_path / "log")) == 1
