"""The port's training path against the JAX package on the CPU: the
attention and Chamfer backward (the plain versions of the K2 and K5
kernels and their autograd Functions), the optimizer against optax, and
the train step against JAX `make_train_step` on the same weights, data
and noise.

The JAX side runs as its own tests run it on the CPU: either with its
Pallas kernels in interpret mode (MultiHeadAttention's packed gate
patched open, `best_chamfer` patched to `chamfer_distance_pallas`), or
on its own CPU path (`_xla_attention`, which rounds q, k, v and P to
bf16 even in an f32 model, and the tiled Chamfer). Every bound below
sits beside the max difference it was set from.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import vae_song_tpu.models.setvae as jax_setvae
from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.ops import chamfer as jax_chamfer
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models import setvae as torch_setvae
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.ops import chamfer, denseattn
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step, make_train_step

from jax_parity import grads_capture

B, N, LATENT = 8, 128, 16          # the Pallas Chamfer needs B % 8 == 0
MODEL_PARAMS = dict(latent_channel=LATENT, num_points=N, d_model=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, ff_dim=64)
BETA, ALPHA, WU_ALPHA, LR, STEPS = 0.001, 0.5, 0.3, 1e-2, 3


# ---------------------------------------------------------------- K2


def _jax_packed_attention(b, n, h, dtype, seed):
    """Inputs and the JAX packed kernels' forward and backward (interpret
    mode), as numpy: q, k, v, do, o [B, N, H*64], lse [B, H, N] (heads
    2j and 2j + 1 from lse_a / lse_b), dq, dk, dv."""
    rng = np.random.default_rng(seed)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    mk = lambda s: jnp.asarray(rng.normal(size=(b, n, h * 64)).astype(np.float32) * s, jdt)
    q, k, v, do = mk(2.0), mk(2.0), mk(1.0), mk(1.0)
    scale = 0.125
    o, lse_a, lse_b = jax_denseattn._call_fwd_packed(q, k, v, scale, True)
    dq, dk, dv = jax_denseattn._call_bwd_packed(q, k, v, do, o, lse_a, lse_b, scale, True)
    lse = jnp.stack([lse_a[..., 0], lse_b[..., 0]], axis=2).reshape(b, h, n)
    to_t = lambda a: torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(dtype)
    return [to_t(a) for a in (q, k, v, do, o)], to_t(lse).float(), [to_t(a) for a in (dq, dk, dv)]


# f32: the same products, summation order only (measured 2.9e-6 at
# max|d| ~ 6); bound 1e-6 of max|d|. bf16: both sides round the exp2
# argument S2 - LSE2 to bf16 (one ulp is 2^-6 at |arg| in [2, 4), so P
# moves 1.1% when the f32 scores feeding it differ in their last bits,
# as two summation orders make them), then round P and dS again. Each
# side is that far from the same math in f32 (measured: port 0.14 /
# 0.16 / 0.060, JAX 0.26 / 0.25 / 0.19 on dq / dk / dv at max|d| ~ 6),
# and the two are as far apart (measured 0.22 / 0.16 / 0.16); bound
# 2^-4 of max|d|, and the port no farther from the f32 math than JAX.
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6), (torch.bfloat16, 2.0 ** -4)])
def test_attention_bwd_plain_matches_jax_kernel(dtype, tol):
    b, n, h = 2, 256, 2
    (q, k, v, do, o), lse, want = _jax_packed_attention(b, n, h, dtype, seed=1)
    view = lambda t: t.view(b, n, h, 64)
    got = denseattn.dense_attention_bwd_plain(view(q), view(k), view(v), view(o), lse,
                                              view(do), 0.125)
    exact = denseattn.dense_attention_bwd_plain(*(view(t.float()) for t in (q, k, v, o)), lse,
                                                view(do.float()), 0.125)
    for name, g, w, e in zip(("dq", "dk", "dv"), got, want, exact):
        assert g.dtype == dtype, name
        g, w, e = g.reshape(b, n, -1).float(), w.float(), e.reshape(b, n, -1)
        err = float((g - w).abs().max())
        assert err <= tol * float(w.abs().max()), (name, err)
        assert float((g - e).abs().max()) <= float((w - e).abs().max()) + 1e-6, name


def test_attention_forward_lse_matches_jax_kernel():
    """The forward's base-2 LSE is laid out [B, H, N]: head 2j is JAX's
    lse_a, head 2j + 1 its lse_b (measured 1.9e-6 on LSE2 ~ 10, and
    2.6e-6 on O, f32)."""
    b, n, h = 2, 256, 2
    (q, k, v, _, o), lse, _ = _jax_packed_attention(b, n, h, torch.float32, seed=2)
    view = lambda t: t.view(b, n, h, 64)
    o_p, lse_p = denseattn.dense_attention_fwd_plain(view(q), view(k), view(v), 0.125)
    assert float((lse_p - lse).abs().max()) <= 1e-5
    assert float((o_p.reshape(b, n, -1) - o).abs().max()) <= 1e-5


@pytest.mark.parametrize("strided", [False, True])
def test_attention_function_grads_match_autograd_of_plain(strided):
    """The autograd Function (forward K1, backward K2; their plain
    versions here) against autograd through the plain forward, f32
    (measured 8.3e-7 at max|d| ~ 1.3)."""
    b, n, h = 2, 128, 2
    gen = torch.Generator().manual_seed(3)
    if strided:       # q/k/v as views of one packed projection, as the model gives them
        qkv = torch.randn(b, n, 3 * h * 64, generator=gen)
        leaves = [qkv.requires_grad_()]
        q, k, v = (qkv[..., i * h * 64:(i + 1) * h * 64].view(b, n, h, 64) for i in range(3))
    else:
        q, k, v = (torch.randn(b, n, h, 64, generator=gen).requires_grad_() for _ in range(3))
        leaves = [q, k, v]
    w = torch.randn(b, n, h, 64, generator=gen)
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    assert not lse.requires_grad
    got = torch.autograd.grad((o * w).sum(), leaves)
    o_ref, _ = denseattn.dense_attention_fwd_plain(q, k, v, 0.125)
    want = torch.autograd.grad((o_ref * w).sum(), leaves)
    for g, r in zip(got, want):
        assert float((g - r).abs().max()) <= 1e-5 * float(r.abs().max())


def test_attention_saves_nothing_without_grad():
    q = torch.randn(1, 64, 2, 64)
    o, _ = denseattn.dense_attention_fwd(q, q, q, 0.125)
    assert o.grad_fn is None
    with torch.no_grad():
        o, _ = denseattn.dense_attention_fwd(q.requires_grad_(), q, q, 0.125)
    assert o.grad_fn is None


# ---------------------------------------------------------------- K5


def _clouds(dup: bool, seed: int):
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, N, 3)).astype(np.float32)
    gt = rng.normal(size=(B, N, 3)).astype(np.float32)
    if dup:
        # many gt points nearest to the same few pred points, and gt
        # points that repeat: several argg entries share an index, and
        # several argp entries too
        gt[:, : N // 2] = pred[:, :4].repeat(N // 8, axis=1) + 1e-3
        gt[:, N // 2: N // 2 + 8] = gt[:, N // 2: N // 2 + 1]
    return pred, gt


def _all_to_one_clouds(seed: int):
    """Every gt point's nearest pred point is pred point 0: gt lies within
    1e-3 of it and the other pred points lie 100 away, so the inverse list
    of pred point 0 holds all N gt points."""
    rng = np.random.default_rng(seed)
    pred = rng.normal(size=(B, N, 3)).astype(np.float32)
    pred[:, 1:] += 100.0
    gt = (pred[:, :1] + 1e-3 * rng.random(size=(B, N, 3))).astype(np.float32)
    return pred, gt


@pytest.mark.parametrize("dup", [False, True, "all_to_one"])
def test_chamfer_bwd_plain_matches_jax(dup):
    """`chamfer_bwd_plain` against `_chamfer_bwd_xla` (the same gather and
    scatter-add; measured 0, bitwise) and against the Pallas backward in
    interpret mode, which routes through bf16 hi/lo column pairs
    (measured 3.6e-7 at max|d| 1.7e-2), on argmins from the Pallas
    forward; also where one pred point is every gt point's nearest."""
    if dup == "all_to_one":
        pred, gt = _all_to_one_clouds(seed=7)
    else:
        pred, gt = _clouds(dup, seed=4 + dup)
    jp, jg = jnp.asarray(pred), jnp.asarray(gt)
    _, argp, _, argg = jax_chamfer._chamfer_pallas_fwd_impl(jp, jg, 128, interpret=True)
    argp, argg = np.asarray(argp), np.asarray(argg)
    if dup == "all_to_one":
        assert (argg == 0).all()
    elif dup:
        assert len(np.unique(argg[0])) < N // 2 and len(np.unique(argp[0])) < N // 2
    want_xla = jax_chamfer._chamfer_bwd_xla((jp, jg, jnp.asarray(argp), jnp.asarray(argg)), 1.0)
    want_pallas = jax_chamfer._chamfer_bwd_pallas(jp, jg, jnp.asarray(argp), jnp.asarray(argg),
                                                  128, interpret=True)
    got = chamfer.chamfer_bwd_plain(torch.from_numpy(pred), torch.from_numpy(gt),
                                    torch.from_numpy(argp), torch.from_numpy(argg))
    for g, wx, wp in zip(got, want_xla, want_pallas):
        assert g.dtype == torch.float32
        wx, wp = np.asarray(wx), np.asarray(wp)
        np.testing.assert_allclose(g.numpy(), wx, atol=1e-6 * np.abs(wx).max(), rtol=0)
        np.testing.assert_allclose(g.numpy(), wp, atol=1e-4 * np.abs(wp).max(), rtol=0)


def test_chamfer_function_grads_match_autograd():
    """The packed Chamfer's autograd Function (K4 forward, K5 backward;
    their plain versions here), scaled by the incoming gradient, against
    autograd of the Chamfer value through the same argmins. (The packed
    keys drop 11 mantissa bits, so at near-ties their argmin can differ
    from the exact one: the tiled path's gradient is not the reference.)
    Measured 1.9e-9 at max|d| 1.7e-2."""
    pred, gt = (torch.from_numpy(a).requires_grad_() for a in _clouds(False, seed=6))
    got = torch.autograd.grad(3.0 * chamfer.chamfer_distance_packed(pred, gt), (pred, gt))
    _, argp, _, argg = chamfer.chamfer_nn_packed_plain(pred.detach(), gt.detach())
    take = lambda pts, idx: torch.gather(pts, 1, idx.long()[..., None].expand(-1, -1, 3))
    value = (((pred - take(gt, argp)) ** 2).sum(-1).mean(1)
             + ((gt - take(pred, argg)) ** 2).sum(-1).mean(1)).mean()
    want = torch.autograd.grad(3.0 * value, (pred, gt))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5 * float(w.abs().max())


# ---------------------------------------------------------------- optimizer


def _optax_grads(grads_np, tx, steps=1):
    params = {f"p{i}": jnp.zeros_like(jnp.asarray(g)) for i, g in enumerate(grads_np)}
    grads = {f"p{i}": jnp.asarray(g) for i, g in enumerate(grads_np)}
    state = tx.init(params)
    for _ in range(steps):
        updates, state = tx.update(grads, state, params)
        params = optax.apply_updates(params, updates)
    return [np.asarray(updates[f"p{i}"]) for i in range(len(grads_np))], params


def _port_clip(grads_np, grad_clip):
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads_np]
    opt = make_optimizer(params, lr=LR, grad_clip=grad_clip)
    for p, g in zip(params, grads_np):
        p.grad = torch.from_numpy(g.copy())
    opt.clip([p.grad for p in params])
    return [p.grad.numpy() for p in params]


def test_cosine_lr_matches_optax():
    total = 10
    sched = optax.cosine_decay_schedule(LR, total)
    params = [torch.zeros(2, requires_grad=True)]
    opt = make_optimizer(params, lr=LR, total_steps=total)
    seen = {}
    for k in range(total + 2):
        seen[k] = opt.lr()
        params[0].grad = torch.ones(2)
        opt.step()
    for k in (0, total // 2, total, total + 1):
        assert seen[k] == pytest.approx(float(sched(k)), rel=1e-6, abs=1e-12)
    assert seen[total] == 0.0 and seen[total + 1] == 0.0


@pytest.mark.parametrize("scale", [0.1, 10.0])
def test_global_norm_clip_matches_optax(scale):
    """Below max_norm nothing changes; above, optax scales by max_norm /
    norm (not torch's max_norm / (norm + 1e-6))."""
    rng = np.random.default_rng(7)
    grads = [rng.normal(size=s).astype(np.float32) * scale for s in ((3, 4), (5,))]
    norm = float(np.sqrt(sum((g.astype(np.float64) ** 2).sum() for g in grads)))
    assert (norm > 1.0) == (scale == 10.0)
    want = [np.asarray(u) for u in
            optax.clip_by_global_norm(1.0).update(
                {f"p{i}": jnp.asarray(g) for i, g in enumerate(grads)}, None)[0].values()]
    got = _port_clip(grads, {"enabled": True, "clip_type": "norm", "max_norm": 1.0})
    for g, w, orig in zip(got, want, grads):
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        if scale < 1:
            np.testing.assert_array_equal(g, orig)


@pytest.mark.parametrize("grad_clip", [
    {"enabled": True, "clip_type": "norm", "max_norm": 0.5, "norm_type": 1.0},
    {"enabled": True, "clip_type": "norm", "max_norm": 0.5, "norm_type": float("inf")},
    {"enabled": True, "clip_type": "value", "clip_value": 0.3},
])
def test_pnorm_and_value_clips_match_jax(grad_clip):
    rng = np.random.default_rng(8)
    grads = [rng.normal(size=s).astype(np.float32) for s in ((3, 4), (6,))]
    if grad_clip["clip_type"] == "value":
        clip = optax.clip(grad_clip["clip_value"])
    else:
        clip = jax_state.clip_by_global_pnorm(grad_clip["max_norm"], grad_clip["norm_type"])
    tree = {f"p{i}": jnp.asarray(g) for i, g in enumerate(grads)}
    want = clip.update(tree, clip.init(tree))[0]
    got = _port_clip(grads, grad_clip)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g, np.asarray(want[f"p{i}"]), rtol=1e-6, atol=1e-7)


def test_unknown_clip_type_raises():
    with pytest.raises(ValueError, match="clip_type"):
        make_optimizer([torch.zeros(1, requires_grad=True)],
                       grad_clip={"enabled": True, "clip_type": "bogus"})


def test_adam_with_clip_matches_optax_over_steps():
    """Three updates of the chained clip + Adam + cosine schedule on fixed
    gradients. The port's Adam computes the bias corrections 1 - b^t in
    f32 as optax does (torch.optim.Adam, in double, measured 7.4e-6
    relative here); now measured 7.9e-8 relative at |param| ~ 2e-2, under
    one f32 ulp (the learning rate and the sums round at other points):
    bound two f32 ulps."""
    rng = np.random.default_rng(9)
    grads = [rng.normal(size=s).astype(np.float32) * 3 for s in ((4, 3), (7,))]
    grad_clip = {"enabled": True, "clip_type": "norm", "max_norm": 1.0}
    tx = jax_state.make_optimizer(lr=LR, total_steps=4, grad_clip=grad_clip)
    _, want = _optax_grads(grads, tx, steps=3)
    params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
    opt = make_optimizer(params, lr=LR, total_steps=4, grad_clip=grad_clip)
    for _ in range(3):
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
    assert opt.count == 3
    for i, p in enumerate(params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(want[f"p{i}"]),
                                   rtol=2.5e-7, atol=0)


# ---------------------------------------------------------------- train step


def _patch_jax_kernels(monkeypatch):
    """JAX MultiHeadAttention through its packed Pallas kernel and the
    set models' Chamfer through its Pallas forward and backward, all in
    interpret mode (as tests/test_denseattn_packed.py and
    tests/test_chamfer_bwd_kernel.py run them on the CPU); the port
    through the same packed Chamfer (truncated keys) on its side."""
    monkeypatch.setattr(jax_attention, "_packed_attn_ok",
                        lambda n_q, n_kv, h, d: jax_denseattn.packed_ok(n_q, n_kv, h, d))
    monkeypatch.setattr(jax_denseattn, "dense_attention_packed",
                        functools.partial(jax_denseattn.dense_attention_packed, interpret=True))
    monkeypatch.setattr(jax_chamfer, "_chamfer_pallas_fwd_impl",
                        functools.partial(jax_chamfer._chamfer_pallas_fwd_impl, interpret=True))
    monkeypatch.setattr(jax_chamfer, "_chamfer_bwd_pallas",
                        functools.partial(jax_chamfer._chamfer_bwd_pallas, interpret=True))
    monkeypatch.setattr(jax_setvae, "best_chamfer",
                        lambda p, g: jax_chamfer.chamfer_distance_pallas(p, g, 128))
    monkeypatch.setattr(torch_setvae, "best_chamfer", chamfer.chamfer_distance_packed)


def _train_both(monkeypatch, kind, mixed, overrides=None, grad_mode=None):
    """STEPS train steps of the JAX package and of the port from the same
    weights (the port's seeded initialisation, handed to JAX through
    vae_song_tpu_torch.weights), on the same clouds and noise, with
    MODEL_PARAMS updated by `overrides` and the gradient `grad_mode`
    (None: the model's). Returns the per-step metrics,
    the first step's gradients and the final parameters of both,
    state_dict-keyed, and the initial parameters."""
    mp = dict(MODEL_PARAMS, mixed_precision=mixed, **(overrides or {}))
    port = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA,
                       generator=torch.Generator().manual_seed(0))
    initial = {k: v.clone() for k, v in port.state_dict().items()}
    params = jax.tree.map(jnp.asarray, weights.state_dict_to_params(initial))
    jmodel = jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    rng = np.random.default_rng(10)
    xs = (rng.normal(size=(STEPS, B, N, 3)) * 0.5).astype(np.float32)
    eps = rng.normal(size=(B, LATENT)).astype(np.float32)

    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == (B, LATENT) else normal(key, shape, dtype)))
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=LR, total_steps=STEPS))
    state = jax_state.TrainState.create(params, {}, tx)
    step = jax_make_train_step(jmodel, tx, grad_mode=grad_mode)
    jax_metrics, jax_grads = [], None
    for i in range(STEPS):
        state, m = step(state, jnp.asarray(xs[i]), WU_ALPHA, jax.random.PRNGKey(i))
        jax_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            jax_grads = jax.tree.map(np.asarray, state.opt_state[0])
    keys = list(initial)
    jax_grads = weights.params_to_state_dict(jax_grads, keys)
    jax_final = weights.params_to_state_dict(jax.tree.map(np.asarray, state.params), keys)

    train_step = make_train_step(port, make_optimizer(port.parameters(), lr=LR, total_steps=STEPS),
                                 grad_mode)
    port_metrics, port_grads = [], None
    for i in range(STEPS):
        m = train_step(torch.from_numpy(xs[i]), torch.from_numpy(eps), WU_ALPHA)
        port_metrics.append({k: float(v) for k, v in m.items()})
        if i == 0:
            port_grads = {k: None if p.grad is None else p.grad.clone()
                          for k, p in port.named_parameters()}
    return (jax_metrics, jax_grads, jax_final), (port_metrics, port_grads, port.state_dict()), initial


def _train_diffs(monkeypatch, kind, mixed, overrides=None, grad_mode=None):
    """(max relative loss-term difference at the first step, the same
    over the later steps, relative L2 difference of the first step's
    gradients, L2 difference of the parameters after STEPS updates
    relative to the L2 of JAX's parameter movement, max |d param|, share
    of parameter elements apart by more than lr/100), after checking the
    parameters that get no gradient."""
    (jm, jg, jp), (pm, pg, pp), initial = _train_both(monkeypatch, kind, mixed, overrides,
                                                      grad_mode)
    rel = lambda j, p: max(abs(p[k] - j[k]) / max(abs(j[k]), 1e-6)
                           for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    first, later = rel(jm[0], pm[0]), max(rel(j, p) for j, p in zip(jm[1:], pm[1:]))
    # the kv-length-1 cross-attention's query/key projections: zero
    # gradients in JAX, none in the port; both leave them unchanged
    frozen = [k for k, g in pg.items() if g is None]
    assert len(frozen) == 4 * MODEL_PARAMS["num_decoder_layers"]
    assert all("cross_attn.query" in k or "cross_attn.key" in k for k in frozen)
    for k in frozen:
        assert not jg[k].any(), k
        assert torch.equal(pp[k], initial[k]) and torch.equal(jp[k], initial[k]), k
    # a key projection's bias has an analytically zero gradient (softmax
    # is shift-invariant along a row): both sides compute roundoff
    keys = [k for k, g in pg.items() if g is not None and not k.endswith("key.bias")]
    num = sum(float(((pg[k] - jg[k]) ** 2).sum()) for k in keys)
    den = sum(float((jg[k] ** 2).sum()) for k in keys)
    deltas = torch.cat([(pp[k] - jp[k]).abs().reshape(-1) for k in keys])
    moved = torch.cat([(jp[k] - initial[k]).reshape(-1) for k in keys])
    return (first, later, (num / den) ** 0.5, float(deltas.norm() / moved.norm()),
            float(deltas.max()), float((deltas > LR / 100).float().mean()))


# Bounds on (first-step loss terms, later-step loss terms, first-step
# gradients, parameters after 3 updates relative to their movement, max
# |d param|, share of elements apart by > lr/100), each beside what was
# measured for setvae / setlrvae. At lr 1e-2 the first updates are about
# lr * sign(g) per element and take the loss from 0.2 to ~20 in this
# tiny model, so an element whose small gradient has the other sign on
# one side moves up to 2 lr a step the other way, and the later steps
# amplify every difference of the first: the first step is held
# tightest. Adam moves an element by at most about its step's rate,
# and the cosine schedule's three rates sum to 2 lr, so the two sides
# can never be more than 4 lr apart: a max |d param| bound at or above
# that could not fail and is left out (None).
# Against the interpret-mode kernels, f32, the same math: 2.8e-7 /
# 2.8e-7, 4.4e-4 / 1.3e-5, 4.4e-6 / 4.4e-7, 4.1e-3 / 6.2e-5, 1.1e-2 /
# 2.9e-4, 8.1e-3 / 7.1e-6.
KERNEL_BOUNDS = (1e-5, 4e-3, 5e-5, 3e-2, 2.1 * LR, 5e-2)
# Against JAX's CPU path, f32: its attention rounds q, k, v and P to
# bf16 even in an f32 model: 4.8e-5 / 4.8e-5, 1.2e-2 / 1.7e-2, 1.3e-2 /
# 3.0e-3, 0.14 / 0.10, 3.4e-2 / 3.5e-2, 0.26 / 0.34.
CPU_F32_BOUNDS = (5e-4, 0.1, 0.05, 0.3, None, 0.6)
# bf16 on both sides, P and the GEMM outputs rounded at other points:
# 7.2e-4 / 7.2e-4, 4.4e-2 / 0.37, 7.4e-2 / 4.4e-2, 0.35 / 0.40, 3.7e-2
# / 3.8e-2, 0.64 / 0.85. The later steps are bounded only by the
# movement (0.8, where independent signs would give about 1.4); the
# share is not bounded.
CPU_BF16_BOUNDS = (5e-3, None, 0.2, 0.8, None, None)


def _assert_within(diffs, bounds):
    assert all(b is None or d <= b for d, b in zip(diffs, bounds)), (diffs, bounds)


def _count_calls(monkeypatch, module, name):
    """Replace module.name by a wrapper that counts its calls."""
    calls, fn = [], getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(1) or fn(*a, **k))
    return calls


def test_train_step_mode_survives_other_steps_being_built():
    """Each step sets its mode on every call: building an eval step and
    the apply functions after the train step leaves the train step in
    train mode, and the eval step in eval mode after a train step."""
    model = build_model("setvae", "shapenet", MODEL_PARAMS,
                        generator=torch.Generator().manual_seed(0))
    modes = []
    model.register_forward_pre_hook(lambda mod, args: modes.append(mod.training))
    train_step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    eval_step = make_eval_step(model)
    _, _, forward = make_apply_fns(model)
    x, eps = torch.randn(2, N, 3), torch.randn(2, LATENT)
    train_step(x, eps)
    eval_step(x, eps)
    train_step(x, eps)
    forward(x)
    assert modes == [True, False, True, False]


# The train steps against JAX's run ~35-55 s each (JAX compiling its
# step): they live in tests/test_torch_train_kernels.py (interpret-mode
# kernels, the staged gradient), tests/test_torch_train_routes.py (the
# BHND route, the fused FFN) and tests/test_torch_train_cpu_f32.py /
# test_torch_train_cpu_bf16.py (JAX's CPU path), so that pytest-xdist's
# --dist loadfile spreads them over its workers; they import the helpers
# above.
