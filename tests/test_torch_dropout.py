"""Training dropout (attn_dropout > 0) in the port against the JAX
package on the CPU, with the same weights, inputs, noise and keep masks.

The masks are injected into both packages: on the JAX side
`flax.linen.stochastic.random` is replaced by a stand-in whose
`bernoulli` hands out numpy masks in call order (and records them); the
port replays the same masks through its mask-source argument, in the
same order, and must ask for the same shapes. Both packages then compute
the training-dropout attention branch with materialised scores (bf16
products accumulated in f32, an f32 softmax, dropout on the weights),
which neither routes to a kernel; JAX runs on its CPU path. Every bound
sits beside the difference it was set from.
"""

import types

import flax.linen.stochastic as flax_stochastic
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import flax.linen as fnn
from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.blocks import dropout, keep_mask
from vae_song_tpu_torch.ops.attention import MultiHeadAttention
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_train_step

from jax_parity import grads_capture, one_thread, patch_eps  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

B, N, LATENT, RATE = 4, 128, 16, 0.1
MODEL_PARAMS = dict(latent_channel=LATENT, num_points=N, d_model=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, ff_dim=64, attn_dropout=RATE)
BETA, ALPHA, WU_ALPHA, LR = 0.001, 0.5, 0.3, 1e-2


class _MaskTape:
    """Keep masks in call order: handed to JAX by `bernoulli` (the
    stand-in for jax.random.bernoulli inside flax.linen.Dropout), which
    draws and records them, and to the port by `source()`, which replays
    them and checks that each shape is the one JAX asked for."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)
        self.masks = []
        self.replayed = 0

    def bernoulli(self, key, p, shape):
        del key
        mask = self.rng.random(tuple(shape)) < p
        self.masks.append(mask)
        return jnp.asarray(mask)

    def source(self):
        def draw(shape, keep_prob):
            mask = self.masks[self.replayed]
            assert mask.shape == tuple(shape), (self.replayed, mask.shape, shape)
            self.replayed += 1
            return torch.from_numpy(mask)

        return draw


@pytest.fixture
def tape(monkeypatch):
    tape = _MaskTape(seed=11)
    monkeypatch.setattr(flax_stochastic, "random", types.SimpleNamespace(bernoulli=tape.bernoulli))
    return tape


def _tt(a, dtype=torch.float32):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(dtype)


# ---------------------------------------------------------------- the helper


@pytest.mark.parametrize("rate", [0.0, 0.1, 0.5, 1.0])
@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_dropout_matches_flax_bitwise(tape, rate, dtype):
    """where(mask, x / keep_prob, 0) in the input's dtype, keep_prob
    rounded to that dtype as JAX rounds the Python scalar: the same bits
    as flax.linen.Dropout on the same mask."""
    x = jnp.asarray(np.random.default_rng(1).normal(size=(3, 5, 7)), dtype)
    want = fnn.Dropout(rate).apply({}, x, deterministic=False,
                                   rngs={"dropout": jax.random.PRNGKey(0)})
    tdt = torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32
    got = dropout(_tt(x, tdt), rate, tape.source())
    assert got.dtype == tdt
    assert torch.equal(got, _tt(want, tdt))
    assert tape.replayed == len(tape.masks) == (1 if 0.0 < rate < 1.0 else 0)


def test_dropout_draws_from_a_generator():
    """A torch.Generator source draws uniform < keep_prob on its device:
    the same seed gives the same mask, about keep_prob of it kept."""
    x = torch.ones(64, 64)
    a = dropout(x, 0.25, torch.Generator().manual_seed(3))
    b = dropout(x, 0.25, torch.Generator().manual_seed(3))
    assert torch.equal(a, b)
    assert set(a.unique().tolist()) <= {0.0, float(torch.tensor(1.0) / 0.75)}
    assert 0.7 < float((a > 0).float().mean()) < 0.8
    with pytest.raises(ValueError):
        dropout(x, 0.25, None)


def test_keep_mask_refuses_a_generator_on_another_device():
    """A generator on one device type for tensors on another raises
    before it draws (a host mask for a model on the card would be copied
    over at every call); a mask-handing callable may come from anywhere."""
    with pytest.raises(ValueError, match="torch.Generator"):
        keep_mask(torch.Generator(), (2, 3), 0.75, "cuda")
    mask = keep_mask(lambda shape, keep: torch.ones(shape, dtype=torch.bool), (2, 3), 0.75, "cpu")
    assert mask.shape == (2, 3) and bool(mask.all())


# ---------------------------------------------------------------- attention


def _mha_pair(n_q, n_kv, dtype, seed):
    rng = np.random.default_rng(seed)
    xq = rng.normal(size=(2, n_q, 128)).astype(np.float32)
    xkv = xq if n_q == n_kv else rng.normal(size=(2, n_kv, 128)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else None
    mha = jax_attention.MultiHeadAttention(num_heads=2, d_model=128, dropout_rate=RATE,
                                           compute_dtype=jdt)
    params = mha.init(jax.random.PRNGKey(seed), xq, xkv)["params"]
    port = MultiHeadAttention(128, 2, RATE, dtype if dtype == torch.bfloat16 else None).train()
    port.load_state_dict({f"{proj}.{leaf}": torch.tensor(
        np.asarray(params[proj]["kernel"]).T if leaf == "weight" else np.asarray(params[proj]["bias"]))
        for proj in ("query", "key", "value", "out") for leaf in ("weight", "bias")})
    return mha, params, port, xq, xkv


# f32 model: both sides round q, k, v and the weights to bf16 and sum in
# f32 in other orders, so a weight within an f32 ulp of a bf16 rounding
# boundary rounds the other way (one bf16 ulp, 2^-8 relative, on that
# weight): measured 1.9e-5 at max|out| 0.20 (9.6e-5 relative) with
# self-attention, 1.9e-7 at 1.25 at kv length 1; bound 5e-4 of max|out|.
# bf16 model: the projections and the output round to bf16 too
# (measured 4.9e-4 at 0.20, one output ulp; 0 at kv length 1); bound
# 2^-6 of max|out|.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 5e-4), (torch.bfloat16, 2.0 ** -6)])
@pytest.mark.parametrize("n_kv", [N, 1])
def test_mha_training_dropout_matches_jax(tape, dtype, tol, n_kv):
    """The training-dropout branch, self-attention and (n_kv = 1) the
    cross-attention's kv-1 shortcut falling through to it, where the
    dropout zeroes whole rows of the [B, H, N, 1] weights; the input
    gradients of the f32 case too (the weight flips above move them more:
    measured 6.7e-5 at max|g| 0.23 with self-attention, bound 2e-3 of
    max|g|; at kv length 1 the query gets no gradient on either side and
    the key/value input's gradients are equal)."""
    mha, params, port, xq, xkv = _mha_pair(N, n_kv, dtype, seed=n_kv)
    w = np.random.default_rng(2).normal(size=(2, N, 128)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(1)}

    def jax_loss(q, kv):
        out = mha.apply({"params": params}, q, kv, train=True, rngs=rngs)
        return (out.astype(jnp.float32) * w).sum(), out

    if n_kv == N:
        (_, want), gq = jax.value_and_grad(lambda q: jax_loss(q, q), has_aux=True)(xq)
        gkv = None
    else:
        (_, want), (gq, gkv) = jax.value_and_grad(jax_loss, argnums=(0, 1), has_aux=True)(xq, xkv)
    assert len(tape.masks) == 1 and tape.masks[0].shape == (2, 2, N, n_kv)
    q = torch.from_numpy(xq).requires_grad_()
    kv = q if n_kv == N else torch.from_numpy(xkv).requires_grad_()
    got = port(q, kv, tape.source())
    assert tape.replayed == 1 and got.dtype == dtype
    want = _tt(want)
    err = float((got.detach().float() - want).abs().max())
    assert err <= tol * float(want.abs().max()), err
    if n_kv == 1:
        # the mask drops whole (head, query) rows of the one-key weights
        assert (~tape.masks[0]).any()
    if dtype == torch.float32:
        leaves = (q,) if n_kv == N else (q, kv)
        grads = torch.autograd.grad((got * torch.from_numpy(w)).sum(), leaves)
        for g, jg in zip(grads, (gq,) if n_kv == N else (gq, gkv)):
            jg = _tt(jg)
            err = float((g - jg).abs().max())
            assert err <= 2e-3 * float(jg.abs().max()), err


def test_mha_eval_ignores_dropout():
    """Eval mode takes the kernel routes, dropout or not: the same output
    as a dropout-free layer with the same weights."""
    _, _, port, xq, _ = _mha_pair(N, N, torch.float32, seed=3)
    plain = MultiHeadAttention(128, 2, 0.0)
    plain.load_state_dict(port.state_dict())
    x = torch.from_numpy(xq)
    with torch.inference_mode():
        assert torch.equal(port.eval()(x, x), plain.eval()(x, x))


# ---------------------------------------------------------------- the model


def _pair(kind, mixed, rate=RATE):
    """The port model (seeded) and the JAX model with the same weights."""
    mp = dict(MODEL_PARAMS, mixed_precision=mixed, attn_dropout=rate)
    port = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA,
                       generator=torch.Generator().manual_seed(0))
    params = jax.tree.map(jnp.asarray, weights.state_dict_to_params(port.state_dict()))
    return port, jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA), params


def _layer0_batches(port):
    """Record the batch each call of the decoder's first self-attention
    sees."""
    seen = []
    port.decoder.layers[0].self_attn.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0].shape[0]))
    return seen


# Encode (two encoder layers: attention output, FFN hidden and FFN
# output dropped) and decode (two decoder layers, layer 0 at full batch,
# the shared dropout after the cross-attention too), f32, the attention
# weights' bf16 flips of test_mha_training_dropout_matches_jax carried
# through the layers: measured 3.6e-6 and 2.9e-6 on mu / logvar at max
# 1.8, 3.1e-5 on the cloud at max|recon| 1.8; bound 1e-4 of the max.
def test_encoder_and_decoder_layers_match_jax_with_dropout(tape):
    port, jmodel, params = _pair("setvae", False)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    z = rng.normal(size=(B, LATENT)).astype(np.float32)
    rngs = {"dropout": jax.random.PRNGKey(5)}
    variables = {"params": params}
    j_mu, j_lv = jmodel.apply(variables, x, train=True, method=jmodel.encode, rngs=rngs)
    n_enc = len(tape.masks)
    j_rec = jmodel.apply(variables, z, train=True, method=jmodel.decode, rngs=rngs)
    # per encoder layer: weights, attention output, FFN hidden, FFN output;
    # per decoder layer: self weights, its output, cross weights, its
    # output, FFN hidden, FFN output
    assert n_enc == 2 * 4 and len(tape.masks) == n_enc + 2 * 6
    seen = _layer0_batches(port)
    port.train()
    src = tape.source()
    mu, lv = port.encode(torch.from_numpy(x), src)
    rec = port.decode(torch.from_numpy(z), src)
    assert tape.replayed == len(tape.masks) and seen == [B]
    for g, w in ((mu, j_mu), (lv, j_lv), (rec, j_rec)):
        w = _tt(w)
        err = float((g.detach() - w).abs().max())
        assert err <= 1e-4 * float(w.abs().max()), err


@pytest.mark.parametrize("rate", [0.0, RATE])
def test_decoder_shortcut_follows_the_dropout_rate(rate):
    """JAX runs the decoder's first self-attention once on the
    batch-constant queries only at dropout_rate 0 (setvae.py:391); with
    dropout configured it runs at full batch, in eval as in training. The
    eval decode matches JAX either way (f32; measured 2.3e-4 at |cloud| <=
    1.8 against JAX's bf16-rounded CPU attention, the bound of
    tests/test_torch_setvae.py: 2e-3)."""
    port, jmodel, params = _pair("setvae", False, rate)
    seen = _layer0_batches(port)
    z = np.random.default_rng(6).normal(size=(B, LATENT)).astype(np.float32)
    _, decode, _ = make_apply_fns(port)
    got = decode(torch.from_numpy(z))
    want = jmodel.apply({"params": params}, z, method=jmodel.decode)
    assert seen == [1 if rate == 0.0 else B]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, rtol=0)


# ---------------------------------------------------------------- the train step


# One train step (composite gradient, Adam at lr 1e-2) from the same
# weights on the same clouds, noise and masks: (loss terms relative,
# gradient relative L2, share of parameter elements apart by > lr/100
# after the update). f32, the attention weights' bf16 flips: measured
# setvae 1.0e-6 / 9.0e-5 / 1.4e-3, setlrvae 1.0e-6 / 9.1e-5 / 6.9e-4
# (Adam's first update is about lr * sign(g), so an element whose tiny
# gradient differs in sign moves 2 lr apart); bounds 1e-5 / 5e-4 / 5e-3.
# bf16, the GEMM and LayerNorm outputs rounded at other points as in
# tests/test_torch_train.py (its CPU_BF16_BOUNDS: 0.2 on the gradient):
# measured 8.3e-4 / 7.2e-2 / 8.2e-2; bounds 5e-3 / 0.2 / 0.25.
@pytest.mark.parametrize("kind,mixed,bounds", [
    ("setvae", False, (1e-5, 5e-4, 5e-3)),
    ("setlrvae", False, (1e-5, 5e-4, 5e-3)),
    ("setvae", True, (5e-3, 0.2, 0.25)),
])
def test_train_step_with_dropout_matches_jax(tape, monkeypatch, kind, mixed, bounds):
    port, jmodel, params = _pair(kind, mixed)
    rng = np.random.default_rng(7)
    x = (rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32)
    eps = rng.normal(size=(B, LATENT)).astype(np.float32)
    patch_eps(monkeypatch, eps)
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=LR))
    state = jax_state.TrainState.create(params, {}, tx)
    state, jm = jax_make_train_step(jmodel, tx)(state, jnp.asarray(x), WU_ALPHA,
                                                jax.random.PRNGKey(0))
    keys = [k for k, _ in port.named_parameters()]
    j_grads = weights.params_to_state_dict(jax.tree.map(np.asarray, state.opt_state[0]), keys)
    j_after = weights.params_to_state_dict(jax.tree.map(np.asarray, state.params), keys)

    step = make_train_step(port, make_optimizer(port.parameters(), lr=LR))
    pm = step(torch.from_numpy(x), torch.from_numpy(eps), WU_ALPHA, tape.source())
    assert tape.replayed == len(tape.masks) > 0
    rel = max(abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-6)
              for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    grads = {k: p.grad for k, p in port.named_parameters()}
    # with dropout the cross-attention takes the materialised branch, so
    # every parameter has a gradient, as in JAX; a key bias's is roundoff
    assert all(g is not None for g in grads.values())
    live = [k for k in keys if not k.endswith("key.bias")]
    num = sum(float(((grads[k] - j_grads[k]) ** 2).sum()) for k in live)
    den = sum(float((j_grads[k] ** 2).sum()) for k in live)
    after = dict(port.named_parameters())
    share = float(torch.cat([(after[k].detach() - j_after[k]).abs().reshape(-1)
                             for k in live]).gt(LR / 100).float().mean())
    diffs = (rel, (num / den) ** 0.5, share)
    assert all(d <= b for d, b in zip(diffs, bounds)), (diffs, bounds)
