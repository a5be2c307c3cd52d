"""The single-device mixture-of-experts FFN of the port (nn/moe.py,
parallel/ep.py) against the JAX package's (vae_song_tpu/nn/moe.py,
parallel/ep.py:56-130), and SetVAE / SetLRVAE with `moe_experts`.

The port routes by index; JAX contracts one-hot [T, E, C] tensors. The
plain version the tests also hold the port to is that einsum form written
in torch (`_einsum_moe`). Parity is held in f32, where JAX's queue
positions (a cumulative sum in x's dtype) are exact, and in bf16 at up to
256 tokens an expert, below which bf16 counts exactly too; past that JAX's
bf16 positions collide (`test_jax_bf16_queue_positions_collide`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.nn.moe import MoEFFN as JaxMoEFFN
from vae_song_tpu.parallel import ep as jax_ep
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.moe import MoEFFN
from vae_song_tpu_torch.parallel import ep
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

from jax_parity import grad_gap, grads_capture, one_thread, patch_eps, to_np  # noqa: F401

D, H, E = 16, 32, 4
FIELDS = ("router", "w1", "b1", "w2", "b2")

# one torch thread a test: pytest-xdist runs six processes on the same cores
pytestmark = pytest.mark.usefixtures("one_thread")


def _moe_inputs(b, n, seed=0):
    """Tokens [b, n, D] and parameters in JAX's layout, from a numpy seed
    (non-zero biases, so every term of the expert FFN counts)."""
    rng = np.random.default_rng(seed)
    shapes = {"router": (D, E), "w1": (E, D, H), "b1": (E, H), "w2": (E, H, D), "b2": (E, D)}
    params = {k: (rng.normal(size=s) * (0.5 if k == "router" else 0.3)).astype(np.float32)
              for k, s in shapes.items()}
    return rng.normal(size=(b, n, D)).astype(np.float32), params


def _port_moe(params, cf, dtype):
    m = MoEFFN(D, H, E, cf, compute_dtype=dtype)
    with torch.no_grad():
        for k in FIELDS:
            getattr(m, k).copy_(torch.from_numpy(params[k]))
    return m


def _jax_run(x, params, cf, dtype, cot):
    """JAX MoEFFN (eager, so each op rounds in its dtype): output, and the
    gradients of sum(out * cot) for x and every parameter."""
    mod = JaxMoEFFN(d_model=D, ff_dim=H, n_experts=E, capacity_factor=cf, compute_dtype=dtype)

    def f(p, xx):
        out = mod.apply({"params": p}, xx)
        return jnp.sum(out.astype(jnp.float32) * cot), out

    (_, out), (gp, gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x))
    return np.asarray(out.astype(jnp.float32)), np.asarray(gx), to_np(gp)


def _port_run(x, params, cf, dtype, cot):
    m = _port_moe(params, cf, dtype)
    xt = torch.from_numpy(x).requires_grad_()
    out = m(xt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    return (out.detach().float().numpy(), xt.grad.numpy(),
            {k: getattr(m, k).grad.numpy() for k in FIELDS})


def _routes(x, params, dtype, cf):
    """(JAX's expert and queue slot of every token from its dispatch
    tensor, -1 where dropped; the port's)."""
    t = x.shape[0] * x.shape[1]
    flat = x.reshape(t, D)
    c = jax_ep._capacity(t, E, cf)
    jx = jnp.asarray(flat).astype(dtype or jnp.float32)
    dispatch, _ = jax_ep._dispatch_combine(jx, jnp.asarray(params["router"]).astype(jx.dtype),
                                           E, c)
    d = np.asarray(dispatch.astype(jnp.float32)).reshape(t, E * c)
    jax_slot = np.where(d.any(axis=1), d.argmax(axis=1), -1)
    tdt = {None: torch.float32, jnp.bfloat16: torch.bfloat16}[dtype]
    _, slot, keep = ep._dispatch_combine(torch.from_numpy(flat).to(tdt),
                                         torch.from_numpy(params["router"]).to(tdt), E, c)
    return jax_slot, torch.where(keep, slot, -1).numpy()


# (compute dtype, clouds, points, capacity factor): f32 with spare
# capacity and with capacity binding (0.5: half the tokens are dropped),
# bf16 with 256 tokens over 4 experts (at most 76 an expert here).
CASES = {
    "f32": (None, 4, 32, 1.25),
    "f32-drops": (None, 4, 32, 0.5),
    "bf16": (jnp.bfloat16, 4, 64, 1.25),
    "bf16-drops": (jnp.bfloat16, 4, 64, 0.5),
}


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_jax(case):
    """Forward and the gradients of x and of every parameter. Routing and
    the queue slots are equal token for token in both dtypes here (the
    port computes the router's softmax in the logits' dtype, op for op as
    jax.nn.softmax does). f32: the output to 1e-5 relative to its max,
    the gradients to 1e-5 relative L2 (measured <= 2.0e-7 and <= 2.8e-7).
    bf16: the output to 1e-2 relative to its max (measured 0; one bf16
    ulp is 7.8e-3 relative), the gradients to 2e-2 relative L2 (measured
    <= 1.1e-2, the router's: autograd's softmax backward and JAX's
    transposed JVP round their bf16 products in another order)."""
    dtype, b, n, cf = CASES[case]
    x, params = _moe_inputs(b, n, seed=1)
    cot = np.random.default_rng(2).normal(size=(b, n, D)).astype(np.float32)
    jax_slot, port_slot = _routes(x, params, dtype, cf)
    np.testing.assert_array_equal(port_slot, jax_slot)
    if cf < 1:
        assert (port_slot < 0).sum() >= b * n // 4          # capacity binds
    j_out, j_gx, j_gp = _jax_run(x, params, cf, dtype, cot)
    tdt = None if dtype is None else torch.bfloat16
    p_out, p_gx, p_gp = _port_run(x, params, cf, tdt, cot)
    dropped = port_slot < 0
    assert not np.abs(p_out.reshape(-1, D)[dropped]).any()   # dropped tokens give zeros
    out_rel = float(np.abs(p_out - j_out).max() / np.abs(j_out).max())
    gaps = {k: float(np.linalg.norm(p_gp[k] - j_gp[k]) / np.linalg.norm(j_gp[k]))
            for k in FIELDS}
    gaps["x"] = float(np.linalg.norm(p_gx - j_gx) / np.linalg.norm(j_gx))
    out_bound, grad_bound = (1e-5, 1e-5) if dtype is None else (1e-2, 2e-2)
    assert out_rel <= out_bound, out_rel
    assert max(gaps.values()) <= grad_bound, gaps


def _einsum_moe(params, x, cf):
    """JAX's moe_ffn_dense written in torch: one-hot dispatch and combine
    [T, E, C] and einsums (the plain version of the indexed form)."""
    t, d = x.shape
    e = params.router.shape[1]
    c = ep._capacity(t, e, cf)
    probs = ep._softmax(x @ params.router)
    expert = probs.argmax(-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot_e = torch.nn.functional.one_hot(expert, e).to(x.dtype)
    pos = (onehot_e.cumsum(0) * onehot_e - onehot_e).sum(-1)
    keep = (pos < c).to(x.dtype)
    onehot_c = torch.nn.functional.one_hot(pos.long().clamp(max=c), c + 1)[:, :c].to(x.dtype)
    dispatch = onehot_e[:, :, None] * onehot_c[:, None, :] * keep[:, None, None]
    combine = dispatch * gate[:, None, None]
    expert_in = torch.einsum("tec,td->ecd", dispatch, x)
    out = ep._expert_ffn(params.w1, params.b1, params.w2, params.b2, expert_in)
    return torch.einsum("tec,ecd->td", combine, out)


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_indexed_form_is_the_einsum_form(dtype, cf):
    """The index form against the one-hot einsum form on the same
    parameters, forward and gradients: bitwise in the output (each einsum
    sum has one non-zero term); the gradients to 1e-6 relative L2 in f32
    (measured <= 1.9e-7) and 1e-2 in bf16 (measured <= 3.8e-3: the
    einsums' backward sums over the one-hot axes in bf16)."""
    x, params = _moe_inputs(4, 64, seed=3)
    m = _port_moe(params, cf, dtype)
    xt = torch.from_numpy(x.reshape(-1, D)).to(dtype)
    outs, grads = [], []
    for fn in (ep.moe_ffn_dense, _einsum_moe):
        for p in m.parameters():
            p.grad = None
        xi = xt.clone().requires_grad_()
        out = fn(m.params(), xi, cf)
        (out.float() * torch.linspace(-1, 1, out.numel()).view_as(out)).sum().backward()
        outs.append(out.detach())
        grads.append([xi.grad.float()] + [getattr(m, k).grad.clone() for k in FIELDS])
    assert torch.equal(outs[0], outs[1])
    bound = 1e-6 if dtype == torch.float32 else 1e-2
    for a, b in zip(*grads):
        assert float((a - b).norm() / b.norm().clamp(min=1e-30)) <= bound


def test_jax_bf16_queue_positions_collide():
    """JAX's `_dispatch_combine` counts each expert's queue with a cumsum
    in x's dtype. In bf16 that count is exact only to 256: with 1000
    tokens on one expert, JAX puts several tokens in one slot (whose
    inputs the dispatch einsum then sums), while the port counts exactly.
    Recorded in ROADMAP.md Queue 3 (where JAX fails and the port does
    not)."""
    t = 1000
    x = np.abs(np.random.default_rng(4).normal(size=(t, D))).astype(np.float32) + 0.1
    router = np.zeros((D, E), np.float32)
    router[:, 0] = 1.0                                   # every token to expert 0
    c = jax_ep._capacity(t, E, 4.0)                      # = t: nothing is dropped
    dispatch, _ = jax_ep._dispatch_combine(jnp.asarray(x, jnp.bfloat16),
                                           jnp.asarray(router, jnp.bfloat16), E, c)
    per_slot = np.asarray(dispatch.astype(jnp.float32)).sum(axis=0)[0]  # [C]
    assert per_slot.max() > 1                            # JAX: tokens share a slot
    assert (per_slot > 0).sum() < 0.6 * t                # measured: 443 distinct slots
    _, slot, keep = ep._dispatch_combine(torch.from_numpy(x).bfloat16(),
                                         torch.from_numpy(router).bfloat16(), E, c)
    assert keep.all() and torch.equal(slot, torch.arange(t))


# ---------------------------------------------------------------- the set models

MP = dict(latent_channel=8, num_points=32, d_model=16, num_heads=2, num_encoder_layers=1,
          num_decoder_layers=1, ff_dim=32, moe_experts=E)
B = 4


def _pair(kind, mixed, seed=0):
    mp = dict(MP, mixed_precision=mixed)
    port = build_model(kind, "shapenet", mp, beta=0.1, alpha=0.5,
                       generator=torch.Generator().manual_seed(seed))
    variables = weights.state_dict_to_variables(port.state_dict())
    return jax_build_model(kind, "shapenet", mp, beta=0.1, alpha=0.5), variables, port


def _clouds(seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, MP["num_points"], 3)) * 0.5).astype(np.float32),
            rng.normal(size=(B, MP["latent_channel"])).astype(np.float32))


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_moe_set_model_forward_and_loss_match_jax(kind):
    """The same weights through the weight map (the MoE leaves as they
    are), the same clouds and noise, f32, JAX's forward jitted:
    reconstruction and loss terms to 1e-5 relative (measured <= 1.5e-7;
    JAX's CPU attention rounds q, k, v and P to bf16 as the port's
    does)."""
    jmodel, variables, port = _pair(kind, False)
    x, eps = _clouds(5)
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    assert sum(p[-1].key == "w1" for p, _ in flat) == 2   # one MoE per transformer layer

    def apply(p):
        mu, logvar = jmodel.apply({"params": p}, jnp.asarray(x), method="encode")
        z = mu + jnp.asarray(eps) * jnp.exp(0.5 * logvar)
        recon = jmodel.apply({"params": p}, z, method="decode")
        z_recon = (jmodel.apply({"params": p}, recon, method="encode")[0]
                   if kind == "setlrvae" else None)
        return recon, mu, logvar, z, z_recon

    jouts = jax.jit(apply)(variables["params"])
    jterms = jmodel.loss(jnp.asarray(x), *jouts, wu_alpha=0.3)
    port.eval()
    with torch.no_grad():
        pouts = port(torch.from_numpy(x), torch.from_numpy(eps))
        pterms = port.loss(torch.from_numpy(x), *pouts, wu_alpha=0.3)
    rel = float(np.abs(pouts[0].numpy() - np.asarray(jouts[0])).max()
                / np.abs(np.asarray(jouts[0])).max())
    assert rel <= 1e-5, rel
    for p, j in zip(pterms, jterms):
        assert abs(float(p) - float(j)) <= 1e-5 * max(1.0, abs(float(j))), (pterms, jterms)


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_moe_set_model_train_step_matches_jax(monkeypatch, kind):
    """One train step from the same weights, clouds and noise, f32 (JAX
    tests/test_moe_setvae.py:53,72 run the same models one step): loss
    terms to 1e-5 relative and the gradient to 1e-4 relative L2 (measured
    1.1e-7 and <= 2.1e-6); every MoE leaf gets a gradient."""
    jmodel, variables, port = _pair(kind, False)
    x, eps = _clouds(6)
    patch_eps(monkeypatch, eps)
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=1e-3))
    state = jax_state.TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                        {}, tx)
    state, jm = jax_make_train_step(jmodel, tx)(state, jnp.asarray(x), 0.3,
                                                 jax.random.PRNGKey(0))
    keys = [k for k, _ in port.named_parameters()]
    j_grads = weights.params_to_state_dict(to_np(state.opt_state[0]), keys)
    pm = make_train_step(port, make_optimizer(port.parameters(), lr=1e-3))(
        torch.from_numpy(x), torch.from_numpy(eps), 0.3)
    rel = max(abs(float(pm[k]) - float(jm[k])) / max(abs(float(jm[k])), 1e-6)
              for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(grads[k] is not None for k in keys if ".moe_ffn." in k)
    live = [k for k in keys if grads[k] is not None and not k.endswith("key.bias")]
    gap = grad_gap(grads, j_grads, live)
    assert rel <= 1e-5 and gap <= 1e-4, (rel, gap)


def test_registry_reads_the_moe_keys():
    """As JAX's registry (tests/test_moe_setvae.py:150), and its refusal
    of experts without attention."""
    m = build_model("setlrvae", "shapenet", {"moe_experts": 2, "num_points": 16, "d_model": 16,
                                             "ff_dim": 32, "num_heads": 2}, beta=0.1, alpha=0.01)
    assert m.moe_experts == 2 and m.moe_capacity_factor == 1.25
    assert m.encoder.layers[0].moe_ffn.w1.shape == (2, 16, 32)
    assert not hasattr(m.encoder.layers[0], "ff_up")
    with pytest.raises(NotImplementedError, match="use_attention"):
        build_model("setvae", "shapenet", {"moe_experts": 2, "use_attention": False})
