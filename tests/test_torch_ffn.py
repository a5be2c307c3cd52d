"""The port's fused FFN (vae_song_tpu_torch/ops/ffn.py: the K6f forward
and K6b backward, their plain versions on the CPU) against the JAX
package's `fused_ffn` run in interpret mode, on the same numpy inputs:
the op with all five gradients, its gate, and the encoder and decoder
layers with VST_FUSED_FFN=1 against the JAX layers with their fused
branch forced on the CPU (the fixture of tests/test_ffn_kernel.py,
reproduced here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_song_tpu.models.setvae as jax_setvae
import vae_song_tpu.ops.ffn as jax_ffn
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models import setvae
from vae_song_tpu_torch.ops import ffn

M, D, F = 1024, 128, 256

# The op's inputs lie on a coarse grid (x and dy in steps of 1/8, the
# weights in steps of 1/256, b1 in steps of 1/2048), so x W1 + b1 and
# dy W2^T are exact in f32 in any summation order and both sides take the
# same ReLU mask (at random f32 inputs an h32 within the summation error
# of 0 flips its mask on one side and moves a whole column of dW1). What
# is left is the order of the later f32 sums before each output's one
# rounding. Measured 0 (bitwise) in f32 and in bf16; bounds as for the
# attention kernels: f32 1e-5 of max|ref|, bf16 2^-6 (two output ulps).
F32_TOL, BF16_TOL = 1e-5, 2.0 ** -6
# Layers: the same weights, inputs and output cotangent through attention
# (64-wide heads in pairs would take the packed kernel; these are 32 wide
# and take the plain attention of both packages, which rounds q, k, v and
# P to bf16 even in f32), the FFN and post-norm LayerNorms; (output bound
# as a share of max|y|, gradient bound as a share of each tensor's
# max|g|). A key projection's bias has an analytically zero gradient
# (the softmax is shift-invariant along a row): both sides compute
# roundoff, and it is left out. f32: measured 1.1e-5 and 3.6e-4 (P's
# bf16 roundings land one ulp apart after f32 sums in other orders);
# bounds 1e-4 and 2e-3. bf16: the GEMM and LayerNorm outputs round to
# bf16 too: measured one output ulp (2^-8) and 4.4e-2; bounds 2^-6 and
# 0.1.
LAYER_TOLS = {False: (1e-4, 2e-3), True: (2.0 ** -6, 0.1)}


def _grid(rng, shape, sd, step):
    return (np.clip(np.round(rng.normal(size=shape) * sd / step), -64, 64) * step).astype(
        np.float32)


def _op_inputs(seed, d=D, f=F):
    """x, dy [M, d]; W1 [d, f], b1, W2 [f, d], b2 in the JAX layout."""
    rng = np.random.default_rng(seed)
    x, dy = _grid(rng, (M, d), 1.0, 1 / 8), _grid(rng, (M, d), 1.0, 1 / 8)
    w1, w2 = _grid(rng, (d, f), d ** -0.5, 1 / 256), _grid(rng, (f, d), f ** -0.5, 1 / 256)
    b1, b2 = _grid(rng, (f,), 0.05, 1 / 2048), _grid(rng, (d,), 0.05, 1 / 2048)
    return x, dy, w1, b1, w2, b2


def _check_against_jax(dtype, d, f, seed):
    """The port's fused_ffn (the plain versions on the CPU) and its five
    gradients against the JAX `fused_ffn` in interpret mode at [M, d]
    rows and hidden width f."""
    x, dy, w1, b1, w2, b2 = _op_inputs(seed, d, f)
    jdt, dt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16,
                                                                         torch.bfloat16)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    j = [jnp.asarray(a, jdt) for a in (x, w1, b1, w2, b2)]
    y_ref, vjp = jax.vjp(lambda *a: jax_ffn.fused_ffn(*a, interpret=True), *j)
    g_ref = vjp(jnp.asarray(dy, jdt))
    # the port takes the weights in its Dense layout: W1^T, W2^T
    leaves = [torch.from_numpy(np.ascontiguousarray(a)).to(dt).requires_grad_()
              for a in (x, w1.T, b1, w2.T, b2)]
    y = ffn.fused_ffn(*leaves)
    grads = torch.autograd.grad(y, leaves, torch.from_numpy(dy).to(dt))
    f32 = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    assert y.dtype == dt and y.shape == (M, d)
    y_ref = f32(y_ref)
    assert np.abs(y.detach().float().numpy() - y_ref).max() <= tol * np.abs(y_ref).max()
    # JAX's dW1 [D, F] and dW2 [F, D] against the port's [F, D] and [D, F]
    for name, g, w, t in zip(("dx", "dw1", "db1", "dw2", "db2"), grads, g_ref,
                             (False, True, False, True, False)):
        w = f32(w).T if t else f32(w)
        assert g.dtype == dt and tuple(g.shape) == w.shape, name
        assert np.abs(g.float().numpy() - w).max() <= tol * np.abs(w).max(), name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,f", [(D, F), (384, 256)])
def test_fused_ffn_matches_jax_interpret(dtype, d, f):
    _check_against_jax(dtype, d, f, seed=0)


def test_plain_versions_take_the_kernels_roundings():
    """bf16: h is rounded once after the f32 bias add (the unfused Dense
    path rounds x W1 first), and db1 sums the f32 dh32, not the rounded
    dh: spelled out here in f32 with explicit roundings."""
    x, dy, w1, b1, w2, b2 = (torch.from_numpy(np.ascontiguousarray(a))
                             for a in _op_inputs(seed=1))
    w1t, w2t = w1.t().contiguous(), w2.t().contiguous()
    bf = lambda t: t.to(torch.bfloat16)
    rd = lambda t: bf(t).float()
    xb, dyb, w1b, b1b, w2b, b2b = (rd(t) for t in (x, dy, w1, b1, w2, b2))
    h32 = torch.relu(xb @ w1b + b1b)
    y = rd(rd(rd(rd(h32) @ w2b) + b2b) + xb)
    dh32 = (dyb @ w2b.t()) * (h32 > 0)
    got_y = ffn.fused_ffn_plain(bf(x), bf(w1t), bf(b1), bf(w2t), bf(b2))
    got = ffn.fused_ffn_bwd_plain(bf(x), bf(dy), bf(w1t), bf(b1), bf(w2t))
    assert torch.equal(got_y.float(), y)
    assert torch.equal(got[0].float(), rd(rd(rd(dh32) @ w1b.t()) + dyb))
    assert torch.equal(got[2].float(), rd(dh32.sum(0)))
    assert torch.equal(got[4].float(), rd(dyb.sum(0)))


@pytest.mark.parametrize("shape", [
    (131072, 256, 512), (131072, 192, 512), (100, 256, 512), (131072, 2048, 8192),
    (1024, 128, 256), (896, 128, 256), (4096, 256, 64), (4096, 128, 128),
])
def test_gate_matches_jax(shape):
    assert ffn.fused_ffn_ok(*shape) == jax_ffn.fused_ffn_ok(*shape)


def test_width_above_kernels_raises():
    """The gate takes D = 512, which the first kernels refused (they were
    built for 128 and 256): the op now takes it like every width the gate
    accepts, and matches the JAX `fused_ffn` there. A width that is no
    multiple of 128 still raises, on the CPU too."""
    assert ffn.fused_ffn_ok(M, 512, 256)
    for dtype in ("float32", "bfloat16"):
        _check_against_jax(dtype, 512, 256, seed=2)
    x = torch.zeros(M, 192)
    with pytest.raises(ValueError, match="multiples of 128"):
        ffn.fused_ffn(x, torch.zeros(256, 192), torch.zeros(256), torch.zeros(192, 256),
                      torch.zeros(192))


def test_cpu_tensors_never_count_launches():
    before = (ffn.fused_ffn_fwd.launches, ffn.fused_ffn_bwd.launches)
    x = torch.randn(1024, D, requires_grad=True)
    args = [torch.randn(F, D), torch.randn(F), torch.randn(D, F), torch.randn(D)]
    ffn.fused_ffn(x, *args).sum().backward()
    assert (ffn.fused_ffn_fwd.launches, ffn.fused_ffn_bwd.launches) == before


# ---------------------------------------------------------------- layers


@pytest.fixture
def fused_on(monkeypatch):
    """Both packages' fused branch on: the JAX model's through the
    interpret-mode kernel and a gate that ignores its TPU-backend check
    (shape checks kept, as tests/test_ffn_kernel.py forces it), the port's
    through the switch itself; counts the port's fused calls."""
    monkeypatch.setattr(jax_ffn, "INTERPRET", True)
    monkeypatch.setattr(
        jax_setvae, "_use_fused_ffn",
        lambda x, f, dr, tr: (not (dr > 0.0 and tr))
        and jax_ffn.fused_ffn_ok(int(np.prod(x.shape[:-1])), x.shape[-1], f),
    )
    monkeypatch.setenv("VST_FUSED_FFN", "1")
    calls = []
    monkeypatch.setattr(setvae, "fused_ffn", lambda *a: calls.append(1) or ffn.fused_ffn(*a))
    return calls


def _layer_case(kind, mixed):
    """(port layer, JAX layer, JAX params from the port's weights, the
    numpy inputs, the state_dict prefix that weights.py maps to the
    layer's Flax scope)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(8, 128, 128)).astype(np.float32)
    mem = rng.normal(size=(8, 1, 128)).astype(np.float32)
    cd, jcd = (torch.bfloat16, jnp.bfloat16) if mixed else (None, None)
    gen = torch.Generator().manual_seed(0)
    if kind == "encoder":
        port = setvae.TransformerEncoderLayer(128, 4, 256, compute_dtype=cd, generator=gen)
        jlayer = jax_setvae.TransformerEncoderLayer(d_model=128, num_heads=4, ff_dim=256,
                                                    compute_dtype=jcd)
        inputs = (x,)
    else:
        port = setvae.TransformerDecoderLayer(128, 4, 256, compute_dtype=cd, generator=gen)
        jlayer = jax_setvae.TransformerDecoderLayer(d_model=128, num_heads=4, ff_dim=256,
                                                    compute_dtype=jcd)
        inputs = (x, mem)
    prefix = f"{kind}.layers.0."
    tree = weights.state_dict_to_params({prefix + k: v for k, v in port.state_dict().items()})
    (scope,) = tree[kind].values()
    return port, jlayer, {"params": scope}, inputs, prefix


@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("kind", ["encoder", "decoder"])
def test_layer_with_fused_ffn_matches_jax(fused_on, kind, mixed):
    port, jlayer, params, inputs, prefix = _layer_case(kind, mixed)
    y_tol, g_tol = LAYER_TOLS[mixed]
    co = np.random.default_rng(4).normal(size=inputs[0].shape).astype(np.float32)

    def jloss(p):
        y = jlayer.apply(p, *(jnp.asarray(a) for a in inputs))
        return (y.astype(jnp.float32) * jnp.asarray(co)).sum(), y

    (_, y_ref), g_tree = jax.value_and_grad(jloss, has_aux=True)(params)
    port.train()
    y = port(*(torch.from_numpy(a) for a in inputs))
    (y.float() * torch.from_numpy(co)).sum().backward()
    assert fused_on, "the port's layer did not take the fused FFN"

    y_ref = np.asarray(y_ref.astype(jnp.float32))
    assert np.abs(y.detach().float().numpy() - y_ref).max() <= y_tol * np.abs(y_ref).max()
    scope = "TransformerEncoderLayer_0" if kind == "encoder" else "TransformerDecoderLayer_0"
    g_jax = weights.params_to_state_dict(
        {kind: {scope: jax.tree.map(np.asarray, g_tree["params"])}},
        [prefix + k for k in port.state_dict()])
    for name, p in port.named_parameters():
        # no gradient: the kv-length-1 cross-attention's query and key
        if p.grad is None or name.endswith("key.bias"):
            continue
        g, w = p.grad.float().numpy(), g_jax[prefix + name].numpy()
        assert np.abs(g - w).max() <= g_tol * np.abs(w).max(), name


@pytest.mark.parametrize("m,d,f,dtype,sms,want", [
    # the shipped shape: 16 output tiles of 128 x 128 (dW1 and dW2), 8 splits
    (131072, 256, 512, torch.bfloat16, 132, 8),
    # 16 f32 tiles of 128 x 128 (the split-TF32 kernel), one block an SM:
    # 8 splits
    (8192, 256, 512, torch.float32, 132, 8),
    # the f32 path's M: splits of at most 2048 rows
    (131072, 256, 512, torch.float32, 132, 64),
    # more tiles than the card has SMs: one split
    (1024, 2048, 2048, torch.bfloat16, 132, 1),
    # few rows: never a split without a 64-row step
    (128, 128, 128, torch.bfloat16, 132, 2),
])
def test_wgrad_splits_fill_the_card(m, d, f, dtype, sms, want):
    assert ffn.wgrad_splits(m, d, f, dtype, sms) == want
