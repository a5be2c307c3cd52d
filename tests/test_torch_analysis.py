"""The Lipschitz / KL analysis of the port (analysis.py, ops/lipschitz.py)
and its scanned trainer (train/scan.py) against the JAX package on the
CPU, on the same draws: the port takes the index pairs, eps and
permutations that JAX's functions draw from their keys (the tests repeat
JAX's key splits to get them, or record them as JAX's jitted trainer
draws them), and gather_cell_samples the same int seed. Every bound sits
beside the difference it was set from."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu import analysis as jax_analysis
from vae_song_tpu.models import LIDVAE as JaxLIDVAE
from vae_song_tpu.models import LRVAE as JaxLRVAE
from vae_song_tpu.ops.lipschitz import estimate_local_lipschitz as jax_estimate
from vae_song_tpu.train import scan as jax_scan
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.loop import init_model
from vae_song_tpu_torch import analysis, weights
from vae_song_tpu_torch.models.flexible import LRVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.ops.lipschitz import estimate_local_lipschitz
from vae_song_tpu_torch.train import scan
from vae_song_tpu_torch.train.state import TrainState, make_optimizer

from jax_parity import to_np

# f32 on both sides; the quantiles and segment means reorder no sum that
# matters: measured up to 1.9e-7 relative to the largest magnitude, bound
# 1e-5
RTOL = 1e-5
RNG = np.random.default_rng(0)
W = RNG.normal(size=(2, 3)).astype(np.float32)
A = RNG.normal(size=(3, 2)).astype(np.float32)


def _jax_decode(z):
    return jnp.tanh(z @ W)


def _decode(z):
    return torch.tanh(z @ torch.from_numpy(W))


def _jax_encode(x):
    return x @ A, 0.5 * jnp.tanh(x @ A)


def _encode(x):
    a = torch.from_numpy(A)
    return x @ a, 0.5 * torch.tanh(x @ a)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol=RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * max(1.0, float(np.abs(want).max())))


def _jax_pairs(key, shape, high):
    k1, k2 = jax.random.split(key)
    return (_t(jax.random.randint(k1, shape, 0, high)), _t(jax.random.randint(k2, shape, 0, high)))


def test_quantile_ratios_match_jax():
    g = [RNG.normal(size=(3, 50, 4, 2)).astype(np.float32) for _ in range(4)]
    g[1][0, :5] = g[0][0, :5]           # zero distances: the eps clamp
    for q in (0.05, 0.25):
        want = jax_analysis._quantile_ratios(*map(jnp.asarray, g), quantile=q)
        got = analysis._quantile_ratios(*map(_t, g), quantile=q)
        for a, b in zip(got, want):
            _close(a, b)


def test_per_cell_kl_matches_jax():
    mu, lv = RNG.normal(size=(200, 2)).astype(np.float32), RNG.normal(size=(200, 2)).astype(
        np.float32)
    labels = RNG.integers(0, 9, 200).astype(np.int32)
    labels[labels == 4] = 5             # an empty cell takes the fill
    want = jax_analysis.per_cell_kl(jnp.asarray(mu), jnp.asarray(lv), jnp.asarray(labels), 9)
    got = analysis.per_cell_kl(_t(mu), _t(lv), _t(labels), 9)
    _close(got[0], want[0])
    assert float(got[0][4]) == analysis.DEFAULT_EMPTY_CELL_FILL_VALUE
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_cellwise_decoder_lipschitz_matches_jax():
    z = RNG.normal(size=(5, 64, 2)).astype(np.float32)
    valid = np.array([True, True, False, True, True])
    key = jax.random.PRNGKey(1)
    want = jax_analysis.cellwise_decoder_lipschitz(_jax_decode, jnp.asarray(z), jnp.asarray(valid),
                                                   key, num_pairs=300)
    idx1, idx2 = _jax_pairs(key, (5, 300), 64)
    got = analysis.cellwise_decoder_lipschitz(_decode, _t(z), _t(valid), idx1=idx1, idx2=idx2)
    for a, b in zip(got, want):
        _close(a, b)
    assert float(got[1][2]) == analysis.DEFAULT_EMPTY_CELL_FILL_VALUE
    # from a generator: the same shapes, the fill in the same place
    drawn = analysis.cellwise_decoder_lipschitz(_decode, _t(z), _t(valid),
                                                torch.Generator().manual_seed(0), num_pairs=300)
    assert [tuple(v.shape) for v in drawn] == [(5,)] * 3 and float(drawn[0][2]) == -5.0


def test_gather_cell_samples_bitwise_for_the_same_seed():
    mu, lv = RNG.normal(size=(300, 2)).astype(np.float32), RNG.normal(size=(300, 2)).astype(
        np.float32)
    labels = RNG.integers(0, 16, 300)
    labels[labels == 3] = 2
    labels[np.flatnonzero(labels == 7)[1:]] = 8   # one member: invalid
    key = jax.random.PRNGKey(5)
    want = jax_analysis.gather_cell_samples(jnp.asarray(mu), jnp.asarray(lv), labels, 16, key,
                                            samples_per_cell=32)
    seed = int(jax.random.randint(key, (), 0, 2 ** 31 - 1))
    got = analysis.gather_cell_samples(_t(mu), _t(lv), labels, 16, seed, samples_per_cell=32)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_array_equal(got[2], want[2])
    assert not bool(got[1][3]) and not bool(got[1][7])


def test_z_grid_samples_and_kl_match_jax():
    key = jax.random.PRNGKey(2)
    want = jax_analysis.z_grid_samples(4, -1.5, 2.0, 2, key, nsamples_per_cell=10)
    eps = _t(jax.random.normal(key, (16, 10, 2)))
    got = analysis.z_grid_samples(4, -1.5, 2.0, 2, eps=eps, nsamples_per_cell=10)
    _close(got, want)
    np.testing.assert_allclose(
        analysis.z_grid_samples(4, -1.0, 1.0, 2, eps=torch.zeros(16, 8, 2))[1, 0].numpy(),
        [-1.0 + 2 / 3, -1.0], atol=1e-6)    # cell 1: x index 1, y index 0
    with pytest.raises(ValueError):
        analysis.z_grid_samples(4, -1, 1, 3, torch.Generator())
    _close(analysis.z_grid_kl(_decode, _encode, got),
           jax_analysis.z_grid_kl(_jax_decode, _jax_encode, want))


@pytest.mark.parametrize("n", [40, 600])
def test_data_based_metrics_match_jax(n):
    """Both branches of data_based_z_samples (n below and above the sample
    count), the data-based KL and the global Lipschitz estimate."""
    mu = RNG.normal(size=(n, 2)).astype(np.float32)
    lv = (0.3 * RNG.normal(size=(n, 2))).astype(np.float32)
    key, kl_key = jax.random.split(jax.random.PRNGKey(3))
    want = jax_analysis.data_based_z_samples(jnp.asarray(mu), jnp.asarray(lv), key, 500)
    if n < 500:
        draws = dict(eps=_t(jax.random.normal(key, (n, 500 // n + 1, 2))))
    else:
        k1, k2 = jax.random.split(key)
        draws = dict(perm=_t(jax.random.permutation(k1, n)), eps=_t(jax.random.normal(k2, (500, 2))))
    got = analysis.data_based_z_samples(_t(mu), _t(lv), num_samples=500, **draws)
    for a, b in zip(got, want):
        _close(a, b)
    assert analysis.data_based_kl(got[1], got[2]) == pytest.approx(
        jax_analysis.data_based_kl(want[1], want[2]), rel=RTOL)
    want_l = jax_analysis.data_based_lipschitz(_jax_decode, want[0], kl_key, num_pairs=400)
    i1, i2 = _jax_pairs(kl_key, (400,), 500)
    got_l = analysis.data_based_lipschitz(_decode, got[0], i1=i1, i2=i2)
    assert got_l == pytest.approx(want_l, rel=RTOL)
    drawn = analysis.data_based_z_samples(_t(mu), _t(lv), torch.Generator().manual_seed(0), 500)
    assert drawn[0].shape == (500, 2)


def test_compute_local_reg_matches_jax():
    X = RNG.normal(size=(100, 2)).astype(np.float32)
    labels = RNG.integers(0, 9, 100)
    labels[labels == 6] = 0
    want = jax_analysis.compute_local_reg(lambda x: jnp.sum(jnp.tanh(x) ** 2), X, labels, 3)
    got = analysis.compute_local_reg(lambda x: torch.sum(torch.tanh(x) ** 2), X, labels, 3)
    _close(got, want)
    assert got[6] == 0.0


def test_estimate_local_lipschitz_matches_jax():
    X = RNG.normal(size=(256, 2)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jax_estimate(_jax_decode, jnp.asarray(X), key, num_pairs=1000)
    i1, i2 = _jax_pairs(key, (1000,), 256)
    assert estimate_local_lipschitz(_decode, _t(X), idx1=i1, idx2=i2) == pytest.approx(
        want, rel=RTOL)
    assert estimate_local_lipschitz(_decode, _t(X[:1]), torch.Generator()) == (0.0, 0.0, 0.0)
    with pytest.raises(NotImplementedError):
        estimate_local_lipschitz(_decode, _t(X), torch.Generator(), metric=1)
    drawn = estimate_local_lipschitz(_decode, _t(X), torch.Generator().manual_seed(0))
    assert drawn[2] == max(drawn[0], drawn[1])


# ---------------------------------------------------------------- the scanned trainer


@pytest.mark.parametrize("strategy", ["linear", "exponential", "repeat_linear", "kl_adaptive"])
def test_precompute_alphas_match_jax(strategy):
    for kw in (dict(), dict(up_amount=0.05, start_epoch=3, repeat_interval=4, initial_alpha=1.0)):
        want = jax_scan.precompute_alphas(23, strategy, **kw)
        got = scan.precompute_alphas(23, strategy, **kw)
        if strategy == "kl_adaptive":
            assert got is None and want is None
            continue
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, np.asarray(want))


def _record(monkeypatch, store):
    """jax.random.normal and .permutation hand JAX's draws, as the jitted
    trainer makes them, to `store` (debug callbacks, in order)."""
    for name in ("normal", "permutation"):
        orig = getattr(jax.random, name)

        def wrapped(*args, _orig=orig, _name=name, **kw):
            v = _orig(*args, **kw)
            jax.debug.callback(lambda a, _n=_name: store[_n].append(np.asarray(a)), v,
                               ordered=True)
            return v

        monkeypatch.setattr(jax.random, name, wrapped)


@pytest.mark.parametrize("model_name,kl_adaptive", [("lrvae", False), ("lrvae", True),
                                                    ("lidvae", False)])
def test_scanned_trainer_matches_jax(monkeypatch, model_name, kl_adaptive):
    """Two epochs of 4 steps with the composite gradient (the Lipschitz
    CLI's setting) from the same weights and statistics, on JAX's
    permutations and eps: the last epoch's mean metrics and last_raw_kl,
    the step count, the final parameters and BatchNorm running variances.
    Measured: metrics up to 5.4e-6 relative, parameters at most 2.0e-6
    apart (none by more than lr/100), variances 3.5e-6; bounds 1e-4 on the
    metrics, 1e-3 of the elements apart by more than lr/100, 1e-5 on the
    variances."""
    n, batch, epochs, lr = 64, 16, 2, 1e-3
    X = np.random.default_rng(1).normal(size=(n, 2)).astype(np.float32)
    if model_name == "lrvae":
        kw = dict(hidden_channels=(8, 8, 2), encoder_type="mlp", decoder_type="mlp", alpha=0.5,
                  beta=0.3)
        jm, port = JaxLRVAE.for_dataset("pinwheel", **kw), LRVAE.for_dataset("pinwheel", **kw)
    else:
        kw = dict(hidden_channels=(8, 2), icnn_channels=(8, 16), inverse_lipschitz=0.2, beta=0.3)
        jm, port = JaxLIDVAE.for_dataset("pinwheel", **kw), LIDVAE.for_dataset("pinwheel", **kw)
    params, bs = jax.jit(lambda x: init_model(jm, x, seed=0))(X[:batch])
    params, bs = to_np(params), to_np(bs)
    weights.load_flax_params(port, params, bs)

    alphas = jax_scan.precompute_alphas(epochs, "linear", initial_alpha=1.0)
    tx = jax_state.make_optimizer(lr=lr)
    store = {"normal": [], "permutation": []}
    _record(monkeypatch, store)
    fit = jax_scan.make_scanned_trainer(jm, tx, batch, epochs, grad_mode="composite",
                                        kl_adaptive=kl_adaptive)
    jstate, jlast = fit(jax_state.TrainState.create(params, bs, tx), jnp.asarray(X),
                        None if kl_adaptive else alphas, jax.random.PRNGKey(7))
    jax.effects_barrier()
    steps = n // batch
    perms = torch.from_numpy(np.stack(store["permutation"])[:, :steps * batch]).long()
    eps = torch.from_numpy(np.stack(store["normal"])).reshape(epochs, steps, 1, batch, 2)

    opt = make_optimizer(port.parameters(), lr=lr, total_steps=None)
    pfit = scan.make_scanned_trainer(port, opt, batch, epochs, grad_mode="composite",
                                     kl_adaptive=kl_adaptive)
    state, last = pfit(TrainState(port, opt), torch.from_numpy(X),
                       scan.precompute_alphas(epochs, "linear", initial_alpha=1.0),
                       perms=perms, eps=eps)
    assert state.step == int(jstate.step) == epochs * steps and opt.count == epochs * steps
    assert set(last) == set(jlast)
    for k in last:
        assert last[k] == pytest.approx(float(jlast[k]), rel=1e-4, abs=1e-6), k
    keys = [k for k, _ in port.named_parameters()]
    j_after = weights.params_to_state_dict(to_np(jstate.params), keys)
    # the biases before a BatchNorm have a zero gradient whose roundoff
    # Adam turns into +-lr (ROADMAP.md Queue 3): left out, as elsewhere
    live = set(keys) - pre_batchnorm_biases(keys)
    moved = torch.cat([(p.detach() - j_after[k]).abs().reshape(-1)
                       for k, p in port.named_parameters() if k in live])
    assert float(moved.gt(lr / 100).float().mean()) < 1e-3
    # the running means carry those biases too: the variances are compared
    var = lambda tree: {k: v for k, v in jax.tree_util.tree_flatten_with_path(tree)[0]
                        if k[-1].key == "var"}
    got_var = var(weights.state_dict_to_variables(port.state_dict())["batch_stats"])
    want_var = var(to_np(jstate.batch_stats))
    assert got_var.keys() == want_var.keys() and len(got_var) > 0
    assert max(float(np.abs(got_var[k] - want_var[k]).max()) / max(1.0, float(np.abs(
        want_var[k]).max())) for k in want_var) < 1e-5


def test_scanned_trainer_draws_from_a_generator():
    """Without explicit draws the run takes them from the generator: the
    same seed gives the same run; a dataset smaller than a batch raises."""
    X = torch.from_numpy(np.random.default_rng(2).normal(size=(48, 2)).astype(np.float32))
    runs = []
    for _ in range(2):
        port = LRVAE.for_dataset("pinwheel", hidden_channels=(8, 2), encoder_type="mlp",
                                 decoder_type="mlp", generator=torch.Generator().manual_seed(0))
        opt = make_optimizer(port.parameters(), lr=1e-3)
        fit = scan.make_scanned_trainer(port, opt, 16, 2)
        runs.append((fit(TrainState(port, opt), X, np.ones(2, np.float32),
                         generator=torch.Generator().manual_seed(3))[1],
                     copy.deepcopy(port.state_dict())))
    assert runs[0][0] == runs[1][0]
    assert all(torch.equal(v, runs[1][1][k]) for k, v in runs[0][1].items())
    with pytest.raises(ValueError, match="smaller than one batch"):
        fit(TrainState(port, opt), X[:8], np.ones(2, np.float32), torch.Generator())
