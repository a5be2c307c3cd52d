"""The arithmetic of the port's bf16 attention kernels for heads of 320
to 512 (csrc/dense_attn_fwd.cu and csrc/dense_attn_bwd.cu, the wgmma
kernels whose two consumer warpgroups split the scores and the head's
columns) emulated in numpy and held, before the card runs them, to the
JAX package's bf16 BHND kernels (`_call_fwd` / `_call_bwd`) in interpret
mode and to the port's plain versions, within the bf16 bounds
chip_smoke.py states.

Forward, for one row, in the kernel's order of work: qc = bf16(q *
qscale); keys in tiles of 64; warpgroup 0 sums the scores over the
head's first ceil(P / 2) 64-column panels, warpgroup 1 over the rest
(each partial sum a float64 sum rounded once to f32: the tensor cores'
order within a product is not modelled), and S2 is their f32 sum (f32
addition commutes, so both warpgroups hold the same S2); then the online
softmax of tests/test_torch_denseattn_bf16wide.py's model: the exact
running max over the tiles so far, P = bf16(ex2(bf16(S2 - m))) with 2^x
below 2^-126 flushed to zero, the row sum in the kernel's thread order,
O accumulated in f32 and stored as bf16(O * (1 / l)), LSE2 = m + log2(l).

Backward: the preprocess (qc, and delta = bf16(rowsum(dO O)) in f32);
the dK/dV kernel in column groups of at most four panels, ceil(P / 4)
of them, each recomputing over the whole head, for every 64-query tile,
S^T and dP^T (float64 sums rounded to f32), P^T = bf16(ex2(bf16(S^T -
LSE2))), dS^T = bf16(P^T * bf16(bf16(dP^T) - bf16(delta))), and adding
P^T dO and dS^T qc on the group's columns into f32 accumulators (each
tile's product a float64 sum rounded once); the dQ kernel likewise over
64-key tiles at the full width. dK = bf16(acc ln 2), dV = bf16(acc), dQ
= bf16(acc scale).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from test_torch_denseattn_bf16wide import (LOG2E, _bf16, _ex2_ftz, _f32, _misses, _row_sums,
                                           _smoke_constant, _to_bh)
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import denseattn

TILE = 64
LN2 = 0.6931471805599453
# chip_smoke.py's bound of the card's bf16 gradients against the plain
# version: K2_BF16_TOL of max|d|, each of dq, dk, dv
GRAD_TOL = _smoke_constant("K2_BF16_TOL")

# (B, N, H, D): one head of 320 over 3 key tiles (panels split 3 + 2 for
# the scores, 2 + 3 for O; dK/dV groups of 2 and 3 panels) and one of 512
# over 2 (4 + 4; groups of 4 and 4)
CASES = [(1, 192, 1, 320), (1, 128, 1, 512)]


def _dot(a, b):
    """a @ b^T over the last axis as a float64 sum rounded once to f32."""
    return _f32(a.astype(np.float64) @ np.swapaxes(b, -1, -2).astype(np.float64))


def _split_scores(qc, k):
    """The forward's S2: warpgroup 0's partial sum over panels [0, ceil(P /
    2)), warpgroup 1's over the rest, added in f32."""
    c = 64 * ((qc.shape[-1] // 64 + 1) // 2)
    return _dot(qc[..., :c], k[..., :c]) + _dot(qc[..., c:], k[..., c:])


def _fwd_model(q, k, v, scale):
    """The kernel's forward on [BH, N, D] bf16-valued f32 arrays: (O as
    bf16-valued f32, LSE2 f32 [BH, N])."""
    bh, n, d = q.shape
    qc = _bf16(q * np.float32(scale * LOG2E))
    acc = np.zeros((bh, n, d), np.float32)
    m = np.full((bh, n), -np.inf, np.float32)
    l4 = np.zeros((bh, n, 4), np.float32)
    for t0 in range(0, n, TILE):
        kt, vt = k[:, t0:t0 + TILE], v[:, t0:t0 + TILE]
        s = _split_scores(qc, kt)
        mn = np.maximum(m, s.max(axis=-1))
        alpha = np.exp2(m - mn).astype(np.float32)
        p = _bf16(_ex2_ftz(_bf16(s - mn[..., None])))
        l4 = _f32(l4.astype(np.float64) * alpha[..., None] + _row_sums(p))
        acc = _f32((acc * alpha[..., None]).astype(np.float64)
                   + p.astype(np.float64) @ vt.astype(np.float64))
        m = mn
    l = (l4[..., 0] + l4[..., 1]) + (l4[..., 2] + l4[..., 3])
    inv = (np.float32(1.0) / l).astype(np.float32)
    return _bf16(acc * inv[..., None]), (m + np.log2(l)).astype(np.float32)


def _groups(p):
    """The dK/dV kernel's column groups of the head's p panels, as column
    slices: ceil(p / 4) groups, group g from panel g p / ng."""
    ng = (p + 3) // 4
    first = [g * p // ng for g in range(ng + 1)]
    return [slice(64 * a, 64 * b) for a, b in zip(first, first[1:])]


def _ds(p, dp, dd):
    """dS = bf16(P * bf16(bf16(dP) - bf16(delta))), as ds_packed rounds it."""
    return _bf16(p * _bf16(_bf16(dp) - dd))


def _bwd_model(q, k, v, o, lse, do, scale):
    """The kernels' backward on [BH, N, D] bf16-valued f32 arrays (lse
    [BH, N] f32): (dq, dk, dv) as bf16-valued f32."""
    bh, n, d = q.shape
    qc = _bf16(q * np.float32(scale * LOG2E))
    delta = _bf16(_f32((do.astype(np.float64) * o.astype(np.float64)).sum(-1)))
    dk = np.zeros((bh, n, d), np.float32)
    dv = np.zeros((bh, n, d), np.float32)
    for cols in _groups(d // 64):          # the dK/dV kernel, one group a launch block
        adk = np.zeros((bh, n, cols.stop - cols.start), np.float32)
        adv = np.zeros_like(adk)
        for t0 in range(0, n, TILE):       # query tiles
            rows = slice(t0, t0 + TILE)
            st = _dot(k, qc[:, rows])      # S^T [keys, queries]
            pt = _bf16(_ex2_ftz(_bf16(st - lse[:, None, rows])))
            dpt = _dot(v, do[:, rows])
            dst = _ds(pt, dpt, delta[:, None, rows])
            adv = _f32(adv + pt.astype(np.float64) @ do[:, rows, cols].astype(np.float64))
            adk = _f32(adk + dst.astype(np.float64) @ qc[:, rows, cols].astype(np.float64))
        dk[..., cols] = _bf16(adk * np.float32(LN2))
        dv[..., cols] = _bf16(adv)
    acc = np.zeros((bh, n, d), np.float32)
    for t0 in range(0, n, TILE):           # the dQ kernel's key tiles
        keys = slice(t0, t0 + TILE)
        s = _dot(qc, k[:, keys])
        p = _bf16(_ex2_ftz(_bf16(s - lse[..., None])))
        dp = _dot(do, v[:, keys])
        acc = _f32(acc + _ds(p, dp, delta[..., None]).astype(np.float64)
                   @ k[:, keys].astype(np.float64))
    return _bf16(acc * np.float32(scale)), dk, dv


@functools.lru_cache(maxsize=None)
def _case(b, n, h, d):
    """Inputs from a numpy seed (rounded to bf16), the JAX forward's O and
    LSE2 (the backward's inputs on every side), and each side's forward
    and backward on [B H, N(, D)]."""
    rng = np.random.default_rng(29 + d)
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
def test_wider_bf16_forward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["fwd"]
    ratios = _misses(out["model"], out[ref])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_wider_bf16_backward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["bwd"]
    ratios = [np.abs(g - w).max() / (GRAD_TOL * np.abs(w).max())
              for g, w in zip(out["model"], out[ref])]
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("b,n,h,d", CASES)
def test_wider_bf16_split_scores_are_modelled(b, n, h, d, one_thread):
    """The two partial sums added in f32 are not one f32 rounding of the
    whole dot product: some scores differ in their last bits, and the
    forward stays within the bounds all the same (the test above)."""
    rng = np.random.default_rng(31 + d)
    qc, kt = (_bf16(rng.normal(size=(1, 64, d)).astype(np.float32) * 2) for _ in range(2))
    split, whole = _split_scores(qc, kt), _dot(qc, kt)
    assert (split != whole).any()
    assert np.abs(split - whole).max() <= 1e-5 * np.abs(whole).max()


def test_wider_bf16_column_groups_cover_the_head_once():
    """The dK/dV kernel's groups (dense_attn_bwd.cu: wider_groups,
    wider_group_first) tile the head's columns in groups of at most 256."""
    for p in range(5, 9):
        cols = _groups(p)
        assert cols[0].start == 0 and cols[-1].stop == 64 * p
        assert all(a.stop == b_.start for a, b_ in zip(cols, cols[1:]))
        assert all(0 < c.stop - c.start <= 256 for c in cols)
    assert [c.stop - c.start for c in _groups(5)] == [128, 192]
    assert [c.stop - c.start for c in _groups(8)] == [256, 256]
