"""The arithmetic of the port's bf16 attention kernels for heads of 576
to 2048 (csrc/dense_attn_fwd.cu and csrc/dense_attn_bwd.cu, the wgmma
kernels run by a thread-block cluster that splits the head) emulated in
numpy and held, before the card runs them, to the JAX package's bf16
BHND kernels (`_call_fwd` / `_call_bwd`) in interpret mode and to the
port's plain versions, within the bf16 bounds chip_smoke.py states.

The cluster: C CTAs (3 up to 12 panels of 64 columns, 4 up to 16, 8
above), CTA r on the head's panels [r P / C, (r + 1) P / C). Each score
tile (64 x 64: S in the forward, S^T and dP^T in the dK/dV kernel) is
summed over the cluster: each CTA's partial sum over its own panels (a
float64 sum rounded once to f32: the tensor cores' order within a
product is not modelled), then the C partial tiles added in f32 in rank
order, ((x_0 + x_1) + x_2) + ...; the rank that owns a block of the tile
adds it and sends it to the others, so every CTA holds the same bits.

Forward, for one row: qc = bf16(q * qscale); keys in tiles of 64; the
cluster's S2; then the online softmax of
tests/test_torch_denseattn_bf16wide.py's model (the exact running max,
P = bf16(ex2(bf16(S2 - m))) flushed below 2^-126, the row sum in the
kernel's thread order), O accumulated in f32 on each CTA's own columns
and stored as bf16(O * (1 / l)), LSE2 = m + log2(l).

Backward: the preprocess (qc, and delta = bf16(rowsum(dO O)) in f32);
the dK/dV kernel, for every 64-query tile, the cluster's S^T and dP^T,
P^T = bf16(ex2(bf16(S^T - LSE2))), dS^T = bf16(P^T * bf16(bf16(dP^T) -
bf16(delta))), and P^T dO and dS^T qc added on each CTA's columns into
f32 accumulators (each tile's product a float64 sum rounded once); dS^T
goes to a bf16 scratch, from which the dQ kernel accumulates dS K over
64-key tiles in f32. dK = bf16(acc ln 2), dV = bf16(acc), dQ = bf16(acc
scale).
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from test_torch_denseattn_bf16wide import (LOG2E, _bf16, _ex2_ftz, _f32, _misses, _row_sums,
                                           _smoke_constant, _to_bh)
from test_torch_denseattn_bf16wider import _dot, _ds
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import denseattn

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                    "vae_song_tpu_torch", "csrc")
TILE = 64
LN2 = 0.6931471805599453
# chip_smoke.py's bound of the card's bf16 gradients against the plain
# version: K2_BF16_TOL of max|d|, each of dq, dk, dv
GRAD_TOL = _smoke_constant("K2_BF16_TOL")

# (B, N, H, D): clusters of 3 (panels 3 + 3 + 3, and 4 + 4 + 4 at the
# d_model 768, num_heads 1 path's width) over 2 key tiles, and of 8 at P =
# 25 (3 panels a CTA, 4 in the last) over 3
CASES = [(1, 128, 1, 576), (1, 128, 1, 768), (1, 192, 1, 1600)]


def _cluster_scores(a, b):
    """a b^T over the last axis as the cluster sums it: each CTA's partial
    sum over its panels rounded once to f32, the partials added in f32 in
    rank order."""
    total = None
    for first, last in denseattn.cluster_panels(a.shape[-1]):
        cols = slice(64 * first, 64 * last)
        part = _dot(a[..., cols], b[..., cols])
        total = part if total is None else (total + part).astype(np.float32)
    return total


def _fwd_model(q, k, v, scale):
    """The kernels' forward on [BH, N, D] bf16-valued f32 arrays: (O as
    bf16-valued f32, LSE2 f32 [BH, N])."""
    bh, n, d = q.shape
    qc = _bf16(q * np.float32(scale * LOG2E))
    acc = np.zeros((bh, n, d), np.float32)
    m = np.full((bh, n), -np.inf, np.float32)
    l4 = np.zeros((bh, n, 4), np.float32)
    for t0 in range(0, n, TILE):
        kt, vt = k[:, t0:t0 + TILE], v[:, t0:t0 + TILE]
        s = _cluster_scores(qc, kt)
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


def _bwd_model(q, k, v, o, lse, do, scale):
    """The kernels' backward on [BH, N, D] bf16-valued f32 arrays (lse
    [BH, N] f32): (dq, dk, dv) as bf16-valued f32."""
    bh, n, d = q.shape
    qc = _bf16(q * np.float32(scale * LOG2E))
    delta = _bf16(_f32((do.astype(np.float64) * o.astype(np.float64)).sum(-1)))
    adk = np.zeros((bh, n, d), np.float32)
    adv = np.zeros((bh, n, d), np.float32)
    dst_all = np.zeros((bh, n, n), np.float32)        # the dS^T scratch [keys, queries]
    for t0 in range(0, n, TILE):                      # the dK/dV kernel's query tiles
        rows = slice(t0, t0 + TILE)
        st = _cluster_scores(k, qc[:, rows])          # S^T [keys, queries]
        pt = _bf16(_ex2_ftz(_bf16(st - lse[:, None, rows])))
        dpt = _cluster_scores(v, do[:, rows])
        dst = _ds(pt, dpt, delta[:, None, rows])
        dst_all[:, :, rows] = dst
        adv = _f32(adv + pt.astype(np.float64) @ do[:, rows].astype(np.float64))
        adk = _f32(adk + dst.astype(np.float64) @ qc[:, rows].astype(np.float64))
    acc = np.zeros((bh, n, d), np.float32)
    for t0 in range(0, n, TILE):                      # the dQ kernel's key tiles
        keys = slice(t0, t0 + TILE)
        ds = dst_all[:, keys].transpose(0, 2, 1)      # dS [queries, keys]
        acc = _f32(acc + ds.astype(np.float64) @ k[:, keys].astype(np.float64))
    return _bf16(acc * np.float32(scale)), _bf16(adk * np.float32(LN2)), _bf16(adv)


@functools.lru_cache(maxsize=None)
def _case(b, n, h, d):
    """Inputs from a numpy seed (rounded to bf16), the JAX forward's O and
    LSE2 (the backward's inputs on every side), and each side's forward
    and backward on [B H, N(, D)]."""
    rng = np.random.default_rng(37 + d)
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
def test_cluster_bf16_forward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["fwd"]
    ratios = _misses(out["model"], out[ref])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("ref", ["jax", "plain"])
@pytest.mark.parametrize("b,n,h,d", CASES)
def test_cluster_bf16_backward_model_within_bounds(b, n, h, d, ref, one_thread):
    out = _case(b, n, h, d)["bwd"]
    ratios = [np.abs(g - w).max() / (GRAD_TOL * np.abs(w).max())
              for g, w in zip(out["model"], out[ref])]
    assert max(ratios) <= 1.0, ratios


@pytest.mark.parametrize("d", [576, 768, 1600])
def test_cluster_bf16_scores_are_modelled(d, one_thread):
    """The cluster's partial sums added in rank order are not one f32
    rounding of the whole dot product: some scores differ in their last
    bits, within 1e-5 of the largest, and the kernels stay within the
    bounds all the same (the tests above)."""
    rng = np.random.default_rng(41 + d)
    qc, kt = (_bf16(rng.normal(size=(1, 64, d)).astype(np.float32) * 2) for _ in range(2))
    split, whole = _cluster_scores(qc, kt), _dot(qc, kt)
    assert (split != whole).any()
    assert np.abs(split - whole).max() <= 1e-5 * np.abs(whole).max()


def test_cluster_panels_cover_the_head_once():
    """Every head of 576 to 2048 (D % 64 == 0) is split over a cluster of
    3, 4 or 8 CTAs, each on 2 to 4 consecutive panels, every panel once;
    the kernels' rule (csrc/sm90.cuh: cluster_ctas) is the one the
    wrapper states."""
    for d in range(576, 2049, 64):
        p = d // 64
        panels = denseattn.cluster_panels(d)
        assert len(panels) == denseattn.cluster_ctas(d) in (3, 4, 8)
        assert panels[0][0] == 0 and panels[-1][1] == p
        assert all(a[1] == b_[0] for a, b_ in zip(panels, panels[1:]))
        assert all(2 <= last - first <= 4 for first, last in panels)
        assert sorted(i for first, last in panels for i in range(first, last)) == list(range(p))
    assert [b_ - a for a, b_ in denseattn.cluster_panels(576)] == [3, 3, 3]
    assert [b_ - a for a, b_ in denseattn.cluster_panels(768)] == [4, 4, 4]
    assert [b_ - a for a, b_ in denseattn.cluster_panels(1600)] == [3, 3, 3, 3, 3, 3, 3, 4]
    with open(os.path.join(CSRC, "sm90.cuh")) as f:
        text = f.read()
    assert re.search(r"constexpr int cluster_ctas\(int P\) \{ return "
                     + re.escape("P <= 12 ? 3 : P <= 16 ? 4 : 8;"), text)
    assert re.search(r"constexpr int cluster_first\(int P, int r\) \{ return "
                     + re.escape("r * P / cluster_ctas(P);"), text)
    assert not denseattn.wgmma_cluster(torch.bfloat16, 512)
    assert all(denseattn.wgmma_cluster(torch.bfloat16, d) for d in range(576, 2049, 64))
    assert not denseattn.wgmma_cluster(torch.bfloat16, 2112)
    assert not denseattn.wgmma_cluster(torch.float32, 768)
