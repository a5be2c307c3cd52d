"""The JAX package's three attention switches in the port's
MultiHeadAttention (vae_song_tpu_torch/ops/attention.py), against the JAX
layer under the same switch, on the same weights and numpy inputs:
VST_DISABLE_DENSE_ATTN, VST_DENSE_ATTN_PACKED and VST_FUSED_QKV, each set
through the environment and read at call time.

On the CPU the JAX layer takes `_xla_attention` whatever the switches
say, because its dense gates also ask for a TPU backend. The `jax_routes`
fixture answers that check with "tpu" (as tests/test_denseattn_packed.py
does) and runs the JAX kernels in interpret mode, so the JAX layer routes
by its own switch logic; both layers record the route they took."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import attention

# Output bounds, port against JAX on one route, as a share of max|out|.
# Kernel routes in f32: the same function in another summation order
# (the port's plain versions against the interpret-mode Pallas kernels;
# measured 3.6e-7); bound 1e-5. The plain route: both sides round q, k, v
# and P to bf16 at f32 inputs summed in other orders, so a P can land one
# bf16 ulp (2^-8 relative) apart (measured 1.8e-4); bound 5e-4. bf16
# compute: the projections' products and bias adds round to bf16 on both
# sides (measured 4.7e-3); bound 2^-6 (two output ulps).
KERNEL_TOL, PLAIN_TOL, BF16_TOL = 1e-5, 5e-4, 2.0 ** -6
# VST_FUSED_QKV against the three projections in the port itself, the
# bounds of tests/test_fused_qkv.py: the [d, 3d] product sums each output
# over the same d products, in f32 within rtol 1e-6 (outputs) and 1e-5 /
# atol 1e-6 (gradients); in bf16 within 2e-2.
QKV_RTOL, QKV_GRAD_RTOL, QKV_GRAD_ATOL, QKV_BF16_TOL = 1e-6, 1e-5, 1e-6, 2e-2

SWITCHES = ("VST_DISABLE_DENSE_ATTN", "VST_DENSE_ATTN_PACKED", "VST_FUSED_QKV")


@pytest.fixture
def jax_routes(monkeypatch):
    """The JAX layer's dense gates see a TPU backend, its kernels run in
    interpret mode, and each route it takes is recorded."""
    for name in SWITCHES:
        monkeypatch.delenv(name, raising=False)
    seen = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    for name, tag in (("dense_attention_packed", "packed"), ("dense_attention", "bhnd")):
        fn = functools.partial(getattr(jax_denseattn, name), interpret=True)
        monkeypatch.setattr(jax_denseattn, name,
                            lambda *a, _fn=fn, _tag=tag: seen.append(_tag) or _fn(*a))
    xla = jax_attention._xla_attention
    monkeypatch.setattr(jax_attention, "_xla_attention",
                        lambda *a, **k: seen.append("plain") or xla(*a, **k))
    return seen


def _port_routes(monkeypatch):
    seen = []
    for name, tag in (("dense_attention_fwd", "packed"), ("dense_attention", "bhnd"),
                      ("attention_plain", "plain")):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _tag=tag: seen.append(_tag) or _fn(*a))
    return seen


def _layers(d_model, heads, n, mixed, seed=0):
    """(JAX layer, its params, port layer with the same weights, the
    numpy input [2, n, d_model])."""
    x = np.random.default_rng(seed).normal(size=(2, n, d_model)).astype(np.float32)
    cd = (jnp.bfloat16, torch.bfloat16) if mixed else (None, None)
    mha = jax_attention.MultiHeadAttention(num_heads=heads, d_model=d_model,
                                           compute_dtype=cd[0])
    params = mha.init(jax.random.PRNGKey(seed), x, x)["params"]
    port = attention.MultiHeadAttention(d_model, heads, compute_dtype=cd[1])
    port.load_state_dict({
        f"{proj}.{leaf}": torch.tensor(
            np.asarray(params[proj]["kernel"]).T if leaf == "weight"
            else np.asarray(params[proj]["bias"]))
        for proj in ("query", "key", "value", "out") for leaf in ("weight", "bias")})
    return mha, params, port, x


def _outputs(mha, params, port, x):
    want = np.asarray(mha.apply({"params": params}, x, x).astype(jnp.float32))
    xt = torch.from_numpy(x)
    with torch.inference_mode():
        got = port(xt, xt).float().numpy()
    return got, want


# (d_model, heads, the switches, the route both layers must take)
ROUTE_CASES = [
    (128, 2, {}, "packed"),
    (128, 2, {"VST_DENSE_ATTN_PACKED": "0"}, "bhnd"),
    (128, 2, {"VST_DENSE_ATTN_PACKED": "false"}, "bhnd"),
    (128, 2, {"VST_DISABLE_DENSE_ATTN": "1"}, "plain"),
    (128, 2, {"VST_DISABLE_DENSE_ATTN": "0"}, "packed"),
    (128, 2, {"VST_DISABLE_DENSE_ATTN": "false", "VST_DENSE_ATTN_PACKED": "1"}, "packed"),
    (128, 1, {}, "bhnd"),
    (128, 1, {"VST_DENSE_ATTN_PACKED": "0"}, "bhnd"),
    (128, 1, {"VST_DISABLE_DENSE_ATTN": "yes"}, "plain"),
]


@pytest.mark.parametrize("d_model,heads,env,route", ROUTE_CASES)
def test_switches_route_as_jax(monkeypatch, jax_routes, d_model, heads, env, route):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    port_seen = _port_routes(monkeypatch)
    mha, params, port, x = _layers(d_model, heads, 128, mixed=False)
    jax_routes.clear()   # the route JAX's init took
    got, want = _outputs(mha, params, port, x)
    assert jax_routes == [route] and port_seen == [route]
    tol = PLAIN_TOL if route == "plain" else KERNEL_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("env", [{}, {"VST_DENSE_ATTN_PACKED": "0"},
                                 {"VST_DISABLE_DENSE_ATTN": "1"}])
def test_fused_qkv_matches_jax(monkeypatch, jax_routes, env, mixed):
    """Self-attention with VST_FUSED_QKV=1 on both sides, under each route."""
    monkeypatch.setenv("VST_FUSED_QKV", "1")
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    mha, params, port, x = _layers(128, 2, 128, mixed=mixed, seed=1)
    got, want = _outputs(mha, params, port, x)
    tol = BF16_TOL if mixed else PLAIN_TOL if "VST_DISABLE_DENSE_ATTN" in env else KERNEL_TOL
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _port_loss_and_grads(port, x, co):
    port.zero_grad()
    xt = torch.from_numpy(x)
    y = port(xt, xt)
    loss = (y.float() * torch.from_numpy(co)).sum()
    loss.backward()
    return y.detach().float().numpy(), {k: p.grad.clone() for k, p in port.named_parameters()}


def test_fused_qkv_outputs_and_grads_match_unfused(monkeypatch):
    """The port's fused in-projection only concatenates the same three
    weights at call time: outputs and all gradients as the three
    projections give them (tests/test_fused_qkv.py's check, in the port)."""
    _, _, port, x = _layers(128, 2, 128, mixed=False, seed=2)
    co = np.random.default_rng(3).normal(size=x.shape).astype(np.float32)
    monkeypatch.setenv("VST_FUSED_QKV", "0")
    y0, g0 = _port_loss_and_grads(port, x, co)
    monkeypatch.setenv("VST_FUSED_QKV", "1")
    y1, g1 = _port_loss_and_grads(port, x, co)
    np.testing.assert_allclose(y1, y0, rtol=QKV_RTOL, atol=QKV_RTOL * np.abs(y0).max())
    assert g0.keys() == g1.keys()
    for name in g0:
        np.testing.assert_allclose(g1[name].numpy(), g0[name].numpy(), rtol=QKV_GRAD_RTOL,
                                   atol=QKV_GRAD_ATOL, err_msg=name)


def test_fused_qkv_bf16_compute_path(monkeypatch):
    """compute_dtype bf16: the fused product casts input, weights and bias
    as Dense(dtype=bf16) does."""
    _, _, port, x = _layers(128, 2, 128, mixed=True, seed=4)
    xt = torch.from_numpy(x)
    outs = []
    for value in ("0", "1"):
        monkeypatch.setenv("VST_FUSED_QKV", value)
        with torch.inference_mode():
            outs.append(port(xt, xt).float().numpy())
    assert outs[1].dtype == np.float32
    np.testing.assert_allclose(outs[1], outs[0], rtol=QKV_BF16_TOL, atol=QKV_BF16_TOL)


def test_fused_qkv_keeps_cross_attention_unfused(monkeypatch):
    """The fusion keys on the query and key/value inputs being one tensor:
    cross-attention calls the three projections, self-attention none."""
    monkeypatch.setenv("VST_FUSED_QKV", "1")
    port = attention.MultiHeadAttention(128, 2, generator=torch.Generator().manual_seed(0))
    calls = []
    for proj in (port.query, port.key, port.value):
        proj.register_forward_hook(lambda *_: calls.append(1))
    q, kv = torch.randn(2, 128, 128), torch.randn(2, 128, 128)
    with torch.inference_mode():
        assert port(q, kv).shape == q.shape
        assert len(calls) == 3
        port(q, q)
    assert len(calls) == 3
    assert sorted(port.state_dict()) == sorted(
        f"{p}.{leaf}" for p in ("query", "key", "value", "out") for leaf in ("weight", "bias"))
