"""The arithmetic of the port's bf16 attention forward for heads of 192
and 256 (csrc/dense_attn_fwd.cu, the wgmma kernel with 64-key tiles)
emulated in numpy and held, before the card runs it, to the JAX package's
bf16 BHND kernel (`_fwd_kernel` through `_call_fwd`) in interpret mode
and to the port's plain version, within the bf16 bounds chip_smoke.py
states.

The emulation follows the kernel's order of work for one row: qc =
bf16(q * qscale) with qscale rounded to f32; keys in tiles of 64, each
tile's scores S2 = qc k^T summed in f32 (a float64 sum rounded once: the
tensor cores' order within a product is not modelled); the exact running
max m over the tiles so far; P = bf16(ex2(bf16(S2 - m))) with 2^x below
2^-126 flushed to zero (p_pair: one conversion rounds a pair of
neighbouring columns, each value to nearest even); the row sum as the
kernel takes it: each of the four threads of a row adds its pairs
(columns 8 j + 2 t and + 1, lo + hi, then into its sum, j in order),
folds its sum into l = fma(l, alpha, sum) with alpha = exp2(m_old -
m_new), and the four sums are added at the end as two shuffles do
((l0 + l1) + (l2 + l3)); O accumulates alpha O + P V in f32 and is
stored as bf16(O * (1 / l)), LSE2 = m + log2(l). So P is rounded against
the running max of 64-key tiles, not the final row max: the test shows
that this stays within the bounds the card is held to.
"""

import ast
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import denseattn

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "chip_smoke.py")
LOG2E = 1.4426950408889634
KEY_TILE = 64


def _smoke_constant(name):
    """The value of the arithmetic on literals that chip_smoke.py assigns
    to its constant `name` (such as 2.0 ** -6)."""
    with open(SMOKE) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets):
                expr = ast.Expression(node.value)
                assert all(isinstance(n, (ast.Expression, ast.Constant, ast.BinOp, ast.UnaryOp,
                                          ast.operator, ast.unaryop))
                           for n in ast.walk(expr)), name
                return eval(compile(expr, SMOKE, "eval"), {"__builtins__": {}})
    raise KeyError(name)


# chip_smoke.py's bounds of the card's bf16 forward against its plain
# version: O within K1_BF16_O_TOL of max(1, max|O|), LSE2 within
# K1_BF16_LSE_TOL of max(1, max|LSE2|).
O_TOL = _smoke_constant("K1_BF16_O_TOL")
LSE_TOL = _smoke_constant("K1_BF16_LSE_TOL")

# (B, N, H, D): two heads of 192 and one of 256 (the bf16 `num_heads: 1`
# SetVAE step's), over 4 and 3 key tiles
CASES = [(1, 256, 2, 192), (1, 192, 1, 256)]


def _bf16(x):
    """f32 to bf16, to nearest even, as f32 (finite inputs)."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    bits = (bits + np.uint32(0x7FFF) + ((bits >> 16) & np.uint32(1))) & np.uint32(0xFFFF0000)
    return bits.view(np.float32)


def _ex2_ftz(x):
    """2^x in f32 with results below 2^-126 flushed to zero (ex2.approx.ftz)."""
    y = np.exp2(x.astype(np.float32))
    return np.where(y < np.float32(2.0 ** -126), np.float32(0.0), y).astype(np.float32)


def _f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def _row_sums(p):
    """The four per-thread partial sums of a tile's P [..., 64], as the
    threads t = 0..3 of a row take them: pairs (8 j + 2 t, + 1), lo + hi
    first, added in j order."""
    parts = []
    for t in range(4):
        s = np.zeros(p.shape[:-1], np.float32)
        for j in range(KEY_TILE // 8):
            c = 8 * j + 2 * t
            s = s + (p[..., c] + p[..., c + 1])
        parts.append(s)
    return np.stack(parts, axis=-1)


def _fwd_model(q, k, v, scale):
    """The kernel's forward on [BH, N, D] bf16-valued f32 arrays: (O as
    bf16-valued f32, LSE2 f32 [BH, N])."""
    bh, n, d = q.shape
    qc = _bf16(q * np.float32(scale * LOG2E))
    acc = np.zeros((bh, n, d), np.float32)
    m = np.full((bh, n), -np.inf, np.float32)
    l4 = np.zeros((bh, n, 4), np.float32)
    for t0 in range(0, n, KEY_TILE):
        kt, vt = k[:, t0:t0 + KEY_TILE], v[:, t0:t0 + KEY_TILE]
        s = _f32(qc.astype(np.float64) @ kt.transpose(0, 2, 1).astype(np.float64))
        mn = np.maximum(m, s.max(axis=-1))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = _bf16(_ex2_ftz(_bf16(s - mn[..., None])))
        # l = fma(l, alpha, partial sum): one rounding
        l4 = _f32(l4.astype(np.float64) * alpha[..., None] + _row_sums(p))
        acc = _f32((acc * alpha[..., None]).astype(np.float64)
                   + p.astype(np.float64) @ vt.astype(np.float64))
        m = mn
    l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
    inv = (np.float32(1.0) / l).astype(np.float32)
    return _bf16(acc * inv[..., None]), (m + np.log2(l)).astype(np.float32)


def _to_bh(a):
    """[B, N, H, D] -> [B H, N, D]."""
    b, n, h, d = a.shape
    return np.ascontiguousarray(a.transpose(0, 2, 1, 3).reshape(b * h, n, d))


@functools.lru_cache(maxsize=None)
def _case(b, n, h, d):
    """Inputs from a numpy seed (rounded to bf16) and each side's (O, LSE2)
    on [B H, N(, D)]."""
    rng = np.random.default_rng(17 + d)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    q, k, v = (_bf16((rng.normal(size=(b, n, h, d)) * s).astype(np.float32))
               for s in (2.0, 2.0, 1.0))
    scale = 1.0 / np.sqrt(d)
    bhnd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16)
    o, lse = jax_denseattn._call_fwd(bhnd(q), bhnd(k), bhnd(v), scale, True)
    jax_out = (np.asarray(o.astype(jnp.float32)).reshape(b * h, n, d),
               np.asarray(lse[..., 0], np.float32).reshape(b * h, n))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    po, plse = denseattn.dense_attention_fwd_plain(tq, tk, tv, scale)
    plain = (_to_bh(po.float().numpy()), plse.numpy().reshape(b * h, n))
    model = _fwd_model(_to_bh(q), _to_bh(k), _to_bh(v), scale)
    return {"jax": jax_out, "plain": plain, "model": model}


def _misses(got, ref):
    """O's and LSE2's errors over their bounds."""
    (o, lse), (o_ref, lse_ref) = got, ref
    return np.array([np.abs(o - o_ref).max() / (O_TOL * max(1.0, np.abs(o_ref).max())),
                     np.abs(lse - lse_ref).max() / (LSE_TOL * max(1.0, np.abs(lse_ref).max()))])


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_wide_bf16_forward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)
    ratios = _misses(out["model"], out[ref])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("b,n,h,d", CASES)
def test_wide_bf16_forward_model_rounds_against_the_running_max(b, n, h, d, one_thread):
    """The model's P is rounded against the running max of 64-key tiles,
    the plain version's against the row max: some outputs differ (the
    model is not the plain version over again), by about an output ulp."""
    out = _case(b, n, h, d)
    (o, _), (o_ref, _) = out["model"], out["plain"]
    assert (o != o_ref).any()
    assert np.abs(o - o_ref).max() <= 2.0 ** -7 * np.abs(o_ref).max()


def test_bf16_rounding_is_to_nearest_even():
    x = np.float32([1.0, 1.0 + 2.0 ** -8, 1.0 + 3 * 2.0 ** -8, -(1.0 + 2.0 ** -8), 3.0e-39])
    got = _bf16(x)
    want = torch.from_numpy(x).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(got, want)
