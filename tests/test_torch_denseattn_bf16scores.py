"""The arithmetic of the port's bf16 attention kernels for heads wider
than 2048 (csrc/dense_attn_scores.cu: wgmma/TMA products over written-out
scores) emulated in numpy and held, before the card runs them, to the
JAX package's bf16 BHND kernels (`_call_fwd` / `_call_bwd`) in interpret
mode and to the port's plain versions, within the bf16 bounds
chip_smoke.py states.

Every product is one wgmma chain over 64-deep steps into an f32
accumulator, modelled as a float64 sum rounded once to f32 (the tensor
cores' order within a product is not modelled).

Forward: qc = bf16(q * qscale); S2 = qc k^T (f32) into a scratch; the row
pass takes the exact max m of each whole row, P = bf16(ex2(bf16(S2 -
m))) flushed below 2^-126, and the row sum l in its thread order (lane i
of the row's warp adds columns 64 j + 2 i and 64 j + 2 i + 1 for j = 0,
1, ... in f32, then the 32 lane sums are added by an xor butterfly, 16,
8, 4, 2, 1); O = bf16((P V) * (1 / l)), LSE2 = m + log2(l).

Backward: the preprocess (qc, and delta = bf16(rowsum(dO O)) in f32);
S2^T = k qc^T and dP^T = v dO^T (f32) of the same tile, P^T =
bf16(ex2(bf16(S2^T - LSE2))), dS^T = bf16(P^T * bf16(bf16(dP^T) -
delta)) into bf16 scratches; dV = bf16(P^T dO), dK = bf16((dS^T qc) ln 2),
dQ = bf16((dS K) scale).
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from test_torch_denseattn_bf16wide import LOG2E, _bf16, _ex2_ftz, _f32, _misses, _smoke_constant, _to_bh
from test_torch_denseattn_bf16wider import _dot, _ds
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import denseattn

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vae_song_tpu_torch", "csrc")
LN2 = 0.6931471805599453
# chip_smoke.py's bound of the card's bf16 gradients against the plain
# version: K2_BF16_TOL of max|d|, each of dq, dk, dv
GRAD_TOL = _smoke_constant("K2_BF16_TOL")

# (B, N, H, D): an odd panel count (33) with a last 128-column tile half
# past D; N = 192, whose last 128-row tile is half past N; two batches at
# the d_model 2304 path's width
CASES = [(1, 128, 1, 2112), (1, 192, 1, 2176), (2, 128, 1, 2304)]


def _row_sum(p):
    """The row pass's sum of P [..., N] (N % 64 == 0) in its thread order:
    each of 32 lanes adds its column pairs in f32, then the lane sums are
    added by an xor butterfly."""
    pairs = p.reshape(*p.shape[:-1], -1, 32, 2)          # [..., j, lane, 2]
    lanes = np.zeros(pairs.shape[:-3] + (32,), np.float32)
    for j in range(pairs.shape[-3]):
        lanes = (lanes + pairs[..., j, :, 0]).astype(np.float32)
        lanes = (lanes + pairs[..., j, :, 1]).astype(np.float32)
    for o in (16, 8, 4, 2, 1):
        lanes = (lanes[..., :o] + lanes[..., o:2 * o]).astype(np.float32)
    return lanes[..., 0]


def _fwd_model(q, k, v, scale):
    """The kernels' forward on [BH, N, D] bf16-valued f32 arrays: (O as
    bf16-valued f32, LSE2 f32 [BH, N])."""
    qc = _bf16(q * np.float32(scale * LOG2E))
    s = _dot(qc, k)                                       # the f32 scratch
    m = s.max(axis=-1)
    p = _bf16(_ex2_ftz(_bf16(s - m[..., None])))          # the bf16 scratch
    l = _row_sum(p)
    inv = (np.float32(1.0) / l).astype(np.float32)
    acc = _f32(p.astype(np.float64) @ v.astype(np.float64))
    return _bf16(acc * inv[..., None]), (m + np.log2(l)).astype(np.float32)


def _bwd_model(q, k, v, o, lse, do, scale):
    """The kernels' backward on [BH, N, D] bf16-valued f32 arrays (lse
    [BH, N] f32): (dq, dk, dv) as bf16-valued f32."""
    qc = _bf16(q * np.float32(scale * LOG2E))
    delta = _bf16(_f32((do.astype(np.float64) * o.astype(np.float64)).sum(-1)))
    st = _dot(k, qc)                                      # S2^T [keys, queries]
    pt = _bf16(_ex2_ftz(_bf16(st - lse[:, None, :])))
    dst = _ds(pt, _dot(v, do), delta[:, None, :])         # dS^T
    dv = _f32(pt.astype(np.float64) @ do.astype(np.float64))
    dk = _f32(dst.astype(np.float64) @ qc.astype(np.float64))
    dq = _f32(np.swapaxes(dst, -1, -2).astype(np.float64) @ k.astype(np.float64))
    return (_bf16(dq * np.float32(scale)), _bf16(dk * np.float32(LN2)), _bf16(dv))


@functools.lru_cache(maxsize=None)
def _case(b, n, h, d):
    """Inputs from a numpy seed (rounded to bf16), the JAX forward's O and
    LSE2 (the backward's inputs on every side), and each side's forward
    and backward on [B H, N(, D)]."""
    rng = np.random.default_rng(43 + d)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    q, k, v, do = (_bf16((rng.normal(size=(b, n, h, d)) * s).astype(np.float32))
                   for s in (2.0, 2.0, 1.0, 1.0))
    scale = 1.0 / np.sqrt(d)
    bhnd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3), jnp.bfloat16)
    o, lse = jax_denseattn._call_fwd(bhnd(q), bhnd(k), bhnd(v), scale, True)
    jo = np.array(o.astype(jnp.float32)).transpose(0, 2, 1, 3)        # [B, N, H, D]
    jlse = np.array(lse[..., 0], np.float32)                           # [B, H, N]
    grads = jax_denseattn._call_bwd(bhnd(q), bhnd(k), bhnd(v), bhnd(do), bhnd(jo),
                                    jnp.asarray(jlse[..., None]), scale, True)
    tq, tk, tv, tdo, to = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v, do, jo))
    po, plse = denseattn.dense_attention_fwd_plain(tq, tk, tv, scale)
    pgrads = denseattn.dense_attention_bwd_plain(tq, tk, tv, to, torch.from_numpy(jlse), tdo,
                                                 scale)
    lse_bh = jlse.reshape(b * h, n)
    return {
        "fwd": {"jax": (_to_bh(jo), lse_bh),
                "plain": (_to_bh(po.float().numpy()), plse.numpy().reshape(b * h, n)),
                "model": _fwd_model(_to_bh(q), _to_bh(k), _to_bh(v), scale)},
        "bwd": {"jax": tuple(np.asarray(g.astype(jnp.float32)).reshape(b * h, n, d)
                             for g in grads),
                "plain": tuple(_to_bh(g.float().numpy()) for g in pgrads),
                "model": _bwd_model(_to_bh(q), _to_bh(k), _to_bh(v), _to_bh(jo), lse_bh,
                                    _to_bh(do), scale)},
    }


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_scores_bf16_forward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["fwd"]
    ratios = _misses(out["model"], out[ref])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_scores_bf16_backward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["bwd"]
    ratios = [np.abs(g - w).max() / (GRAD_TOL * np.abs(w).max())
              for g, w in zip(out["model"], out[ref])]
    assert max(ratios) <= 1.0, ratios


def test_scores_row_sum_order_is_modelled(one_thread):
    """The row pass's lane order is not one running f32 sum over the row:
    some rows' sums differ in their last bits, by no more than a few f32
    ulps of the sum."""
    rng = np.random.default_rng(47)
    p = _bf16(_ex2_ftz(_bf16(-np.abs(rng.normal(size=(256, 2048)) * 4).astype(np.float32))))
    lanes = _row_sum(p)
    running = np.zeros(256, np.float32)
    for c in range(2048):
        running = (running + p[:, c]).astype(np.float32)
    assert (lanes != running).any()
    assert np.abs(lanes - running).max() <= 1e-5 * np.abs(running).max()


def test_scores_rule_takes_bf16_heads_above_2048_only():
    """wgmma_scores takes bf16 heads wider than 2048 and nothing else; at
    no width do it and wgmma_cluster both take a head, and every bf16 head
    of 192 and wider goes to exactly one of the four wgmma routes."""
    bf16 = torch.bfloat16
    assert denseattn.MAX_CLUSTER_HEAD == 2048
    for d in range(64, 8193, 64):
        assert denseattn.wgmma_scores(bf16, d) == (d > 2048)
        assert not denseattn.wgmma_scores(torch.float32, d)
        assert not (denseattn.wgmma_scores(bf16, d) and denseattn.wgmma_cluster(bf16, d))
        routes = [rule(bf16, d) for rule in (denseattn.wgmma_wide, denseattn.wgmma_wider,
                                             denseattn.wgmma_cluster, denseattn.wgmma_scores)]
        assert sum(routes) == (1 if d >= 192 else 0), (d, routes)


def test_scores_scratch_bytes_match_the_kernels():
    """The forward scratch the wrapper allocates is the size the kernels
    carve up (csrc/dense_attn_scores.cuh: attn_scores_fwd_scratch): S2 f32
    and P bf16 [B H, N, N], qc [B, N, H, D], 1 / l f32 [B H, N]."""
    with open(os.path.join(CSRC, "dense_attn_scores.cuh")) as f:
        text = f.read()
    assert re.search(re.escape("return 6 * bhn * N + 2 * bhn * D + 4 * bhn;"), text)
    b, h, n, d = 64, 1, 2048, 2304
    assert denseattn.scores_fwd_scratch_bytes(b, h, n, d) == (
        4 * b * h * n * n + 2 * b * h * n * n + 2 * b * n * h * d + 4 * b * h * n)
    assert denseattn.scores_fwd_scratch_bytes(2, 3, 192, 2112) == (
        6 * 6 * 192 * 192 + 2 * 6 * 192 * 2112 + 4 * 6 * 192)
