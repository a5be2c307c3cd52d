"""The port's dense attention on the BHND route (`dense_attention_bhnd`,
`dense_attention`: the K3f forward and K3b backward, their plain
versions on the CPU) against the JAX package's `dense_attention` and
its `_call_fwd` (the BHND Pallas kernels) in interpret mode, on the same
numpy inputs; and the route MultiHeadAttention takes for each head
shape."""

import functools
import unittest.mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import attention, denseattn

# f32: the same math in another summation order; measured max |d| 6.5e-7
# of max|O|, 8.1e-8 of max|LSE2| ~ 28, 1.0e-6 of max|d| ~ 7 on the
# gradients; bound 1e-5 of max(1, max|ref|).
F32_TOL = 1e-5
# bf16 forward: O rounds to bf16 on both sides (measured 4.7e-3 of
# max|O|, about one ulp, as on the packed route); the LSE differs more
# because jnp.exp2 on bf16 lowers to exp(bf16(ln 2) * x) on the CPU (see
# test_torch_denseattn.py; measured 3.3e-4 of max|LSE2|): bounds 2^-6 and
# 1e-3 of max(1, max|ref|). bf16 gradients: both sides round the exp2
# argument, P, dP and dS to bf16 at different f32 inputs (see
# test_torch_train.py's K2 bound; measured 1.8e-2 of max|d|): 2^-4.
BF16_O_TOL, BF16_LSE_TOL, BF16_GRAD_TOL = 2.0 ** -6, 1e-3, 2.0 ** -4

# (B, N, H, D): the widths the route takes at the shipped d_model 256
# (2 heads of 128, 1 of 256), an odd count of 64-wide heads, two heads of
# 192, and heads wider than 256 (an odd and an even number of 64-column
# panels)
CASES = [(2, 128, 2, 128), (1, 256, 1, 256), (2, 128, 3, 64), (1, 128, 2, 192),
         (1, 128, 1, 320), (1, 128, 2, 512)]


def _inputs(b, n, h, d, seed):
    rng = np.random.default_rng(seed)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    return [(rng.normal(size=(b, n, h, d)) * s).astype(np.float32) for s in (2.0, 2.0, 1.0, 1.0)]


def _jax(q, k, v, do, scale, jdt):
    """O, LSE2 [B, H, N] and (dq, dk, dv) of the JAX BHND kernels."""
    q, k, v, do = (jnp.asarray(a, jdt) for a in (q, k, v, do))
    o, vjp = jax.vjp(lambda a, b, c: jax_denseattn.dense_attention(a, b, c, scale, interpret=True),
                     q, k, v)
    grads = vjp(do)
    bhnd = lambda a: a.transpose(0, 2, 1, 3)
    _, lse = jax_denseattn._call_fwd(bhnd(q), bhnd(k), bhnd(v), scale, True)
    f32 = lambda a: np.asarray(a.astype(jnp.float32))
    return f32(o), f32(lse[..., 0]), [f32(g) for g in grads]


def _port(q, k, v, do, scale, dt):
    leaves = [torch.from_numpy(a).to(dt).requires_grad_() for a in (q, k, v)]
    o, lse = denseattn.dense_attention_bhnd(*leaves, scale)
    assert o.dtype == dt and lse.shape == (q.shape[0], q.shape[2], q.shape[1])
    grads = torch.autograd.grad(o, leaves, torch.from_numpy(do).to(dt))
    f32 = lambda t: t.detach().float().numpy()
    return f32(o), lse.numpy(), [f32(g) for g in grads]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_bhnd_route_matches_jax_interpret(b, n, h, d, dtype):
    q, k, v, do = _inputs(b, n, h, d, seed=b + n + h + d)
    scale = 1.0 / np.sqrt(d)
    jdt, dt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    o_ref, lse_ref, g_ref = _jax(q, k, v, do, scale, jdt)
    o, lse, grads = _port(q, k, v, do, scale, dt)
    o_tol, lse_tol, g_tol = ((F32_TOL,) * 3 if dtype == "float32"
                             else (BF16_O_TOL, BF16_LSE_TOL, BF16_GRAD_TOL))
    assert np.abs(o - o_ref).max() <= o_tol * max(1.0, np.abs(o_ref).max())
    assert np.abs(lse - lse_ref).max() <= lse_tol * max(1.0, np.abs(lse_ref).max())
    for name, g, w in zip(("dq", "dk", "dv"), grads, g_ref):
        assert np.abs(g - w).max() <= g_tol * max(1.0, np.abs(w).max()), name


def test_routes_count_apart_and_cpu_never_counts():
    """The BHND route's own counters; CPU tensors take the plain versions
    and count nothing on either route."""
    counters = (denseattn.dense_attention_fwd, denseattn.dense_attention_bwd,
                denseattn.dense_attention_bhnd, denseattn.dense_attention_bwd_bhnd)
    before = [c.launches for c in counters]
    q = torch.randn(1, 128, 2, 128, requires_grad=True)
    denseattn.dense_attention(q, q, q, 0.1).sum().backward()
    assert [c.launches for c in counters] == before
    assert q.grad is not None and q.grad.shape == q.shape


@pytest.mark.parametrize("shape", [
    (2048, 2048, 128), (2048, 2048, 256), (2048, 2048, 64), (2048, 2048, 96), (2048, 1, 128),
    (4096, 4096, 128), (200, 200, 128), (256, 256, 512),
])
def test_dense_gate_matches_jax(shape):
    assert denseattn.dense_ok(*shape) == jax_denseattn.dense_ok(*shape)


def _route(monkeypatch, d_model, num_heads, n=128):
    """Which of MultiHeadAttention's routes self-attention over n points
    takes: 'packed', 'bhnd' or 'plain'."""
    seen = []
    for name, tag in (("dense_attention_fwd", "packed"), ("dense_attention", "bhnd"),
                      ("attention_plain", "plain")):
        fn = getattr(attention, name)
        monkeypatch.setattr(attention, name,
                            lambda *a, _fn=fn, _tag=tag: seen.append(_tag) or _fn(*a))
    mha = attention.MultiHeadAttention(d_model, num_heads,
                                       generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, n, d_model)
    out = mha(x, x)
    assert out.shape == x.shape
    return seen


@pytest.mark.parametrize("d_model,num_heads,n,want", [
    (256, 4, 128, "packed"),     # 64-wide heads in pairs: K1 / K2
    (256, 2, 128, "bhnd"),       # 128-wide heads: K3f / K3b
    (256, 1, 128, "bhnd"),       # one 256-wide head
    (192, 3, 128, "bhnd"),       # an odd count of 64-wide heads
    (768, 1, 128, "bhnd"),       # one 768-wide head: the cluster kernels
    (2112, 1, 128, "bhnd"),      # one 2112-wide head: the kernels over written-out scores
    (256, 4, 100, "plain"),      # a length neither dense kernel takes
])
def test_attention_routes_as_jax(monkeypatch, d_model, num_heads, n, want):
    assert _route(monkeypatch, d_model, num_heads, n) == [want]


def test_head_width_above_kernels_raises(monkeypatch):
    """dense_ok takes a 512-wide head, which the first kernels refused
    (they were built up to 256): it now takes the BHND route like any
    D % 64 == 0, and the layer's output matches the JAX layer running its
    BHND kernel in interpret mode on the same weights (f32, summation
    order only: F32_TOL). A width that is no multiple of 64 still raises."""
    assert denseattn.dense_ok(128, 128, 512)
    assert _route(monkeypatch, 512, 1) == ["bhnd"]
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_denseattn, "dense_attention",
                        functools.partial(jax_denseattn.dense_attention, interpret=True))
    x = np.random.default_rng(5).normal(size=(1, 128, 512)).astype(np.float32)
    mha = jax_attention.MultiHeadAttention(num_heads=1, d_model=512)
    params = mha.init(jax.random.PRNGKey(0), x, x)["params"]
    want = np.asarray(mha.apply({"params": params}, x, x))
    port = attention.MultiHeadAttention(512, 1)
    port.load_state_dict({
        f"{proj}.{leaf}": torch.tensor(
            np.asarray(params[proj]["kernel"]).T if leaf == "weight"
            else np.asarray(params[proj]["bias"]))
        for proj in ("query", "key", "value", "out") for leaf in ("weight", "bias")})
    with torch.inference_mode():
        got = port(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    assert np.abs(got - want).max() <= F32_TOL * max(1.0, np.abs(want).max())
    q = torch.zeros(1, 128, 1, 96)
    with pytest.raises(ValueError, match="multiple of 64"):
        denseattn.dense_attention(q, q, q, 0.1)


def test_head_of_2112_layer_matches_jax():
    """A head wider than 2048 (the route of the kernels over written-out
    scores on the card) through the whole layer: MultiHeadAttention(2112,
    1)'s output and the gradients of <out, ct> in x and in every weight
    match the JAX layer running its BHND kernels in interpret mode on the
    same weights (f32, summation order only: F32_TOL of max|ref|)."""
    d = 2112
    assert denseattn.dense_ok(128, 128, d) and denseattn.wgmma_scores(torch.bfloat16, d)
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 128, d)).astype(np.float32)
    ct = rng.normal(size=(1, 128, d)).astype(np.float32)
    mha = jax_attention.MultiHeadAttention(num_heads=1, d_model=d)
    params = mha.init(jax.random.PRNGKey(1), x, x)["params"]
    with unittest.mock.patch.object(jax, "default_backend", lambda: "tpu"), \
            unittest.mock.patch.object(
                jax_denseattn, "dense_attention",
                functools.partial(jax_denseattn.dense_attention, interpret=True)):
        loss = lambda p, xx: jnp.sum(mha.apply({"params": p}, xx, xx) * ct)
        want = np.asarray(mha.apply({"params": params}, x, x))
        gp, gx = jax.grad(loss, argnums=(0, 1))(params, x)
    port = attention.MultiHeadAttention(d, 1)
    port.load_state_dict({
        f"{proj}.{leaf}": torch.tensor(
            np.asarray(params[proj]["kernel"]).T if leaf == "weight"
            else np.asarray(params[proj]["bias"]))
        for proj in ("query", "key", "value", "out") for leaf in ("weight", "bias")})
    tx = torch.from_numpy(x).requires_grad_()
    out = port(tx, tx)
    (out * torch.from_numpy(ct)).sum().backward()
    close = lambda got, ref: np.abs(got - ref).max() <= F32_TOL * max(1.0, np.abs(ref).max())
    assert close(out.detach().numpy(), want)
    assert close(tx.grad.numpy(), np.asarray(gx))
    for proj in ("query", "key", "value", "out"):
        layer = getattr(port, proj)
        assert close(layer.weight.grad.numpy().T, np.asarray(gp[proj]["kernel"])), proj
        assert close(layer.bias.grad.numpy(), np.asarray(gp[proj]["bias"])), proj


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,n,h,d", [(2, 128, 2, 128), (1, 192, 4, 64)])
def test_bwd_preprocess_matches_jax_kernel(b, n, h, d, dtype):
    """The backward's preprocess pass (its plain version, which the CPU
    path and the card's checks use) against the JAX `_bwd_kernel`'s own
    expressions for qc (denseattn.py:161) and delta (:182-185, cast to the
    compute dtype where dS uses it): qc bit for bit; delta bit for bit in
    bf16 (on these inputs the f32 sums round to the same bf16) and within
    f32 summation order in f32."""
    q, o, do, _ = _inputs(b, n, h, d, seed=b + n + h + d + 1)
    scale = 1.0 / np.sqrt(d)
    jdt, dt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    jq, jo, jdo = (jnp.asarray(a, jdt) for a in (q, o, do))
    qc_ref = (jq.astype(jnp.float32) * (scale * jax_denseattn.LOG2E)).astype(jq.dtype)
    cd = jax_denseattn._vpu_dtype(jq.dtype)
    delta_ref = (jdo.astype(jnp.float32) * jo.astype(jnp.float32)).sum(axis=-1).astype(cd)
    qc, delta = denseattn.attn_bwd_preprocess_plain(
        *(torch.from_numpy(a).to(dt) for a in (q, o, do)), scale)
    assert qc.dtype == dt and delta.dtype == torch.float32 and delta.shape == (b, h, n)
    np.testing.assert_array_equal(qc.float().numpy(), np.asarray(qc_ref.astype(jnp.float32)))
    # f32: the same products summed in another order
    tol = 0.0 if dtype == "bfloat16" else 1e-5 * np.abs(np.asarray(delta_ref)).max()
    want = np.asarray(delta_ref.astype(jnp.float32)).transpose(0, 2, 1)
    assert np.abs(delta.numpy() - want).max() <= tol
