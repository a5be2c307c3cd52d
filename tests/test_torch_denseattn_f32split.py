"""The arithmetic of the port's f32 attention kernels (split TF32 on the
tensor cores' wgmma: csrc/dense_attn_tf32.cu at D = 64 and 128,
dense_attn_tf32_wide.cu from D = 192) emulated in numpy and held, before
the card runs it, to the JAX package's f32 Pallas kernels in interpret mode
and to a float64 version, within the f32 bounds chip_smoke.py states; and
a one-pass TF32 emulation of the same kernels, which must miss those bounds.

The emulation follows the kernels' order of work. At D = 64 and 128 the
scores stay on chip: the forward walks key tiles (64 keys at D = 64, 32 at
128, _KEY_TILE) with the exact running max, S = qc K^T of a tile summed
over the head's 32-column panels (a fresh accumulator a panel, added in
panel order), O = O alpha + (P V over the tile, one fresh accumulator);
the backward's dK/dV kernel walks tiles of queries (_query_tile): S^T
= K qc^T and dP^T = V dO^T a fresh accumulator each 8 columns,
P^T = exp2(S^T - LSE2), dS^T = P^T
(dP^T - delta), dV += P^T dO and dK += dS^T qc, each tile one fresh
accumulator, dS^T kept for dQ = dS K scale, a product with a fresh
accumulator each 64 keys. From D = 192 the scores are written out: S2 =
qc K^T over the whole head, its exact row max, P = exp2(S2 - m), O = P V /
l; backward S^T = K qc^T, dP^T = V dO^T, P^T and dS^T, then dV = P^T dO,
dK = dS^T qc ln2, dQ = dS K scale, each product over its whole depth in
the depth's order. The permuted contraction of the kernels at 64 and 128
(an accumulator tile as the A operand, csrc/mma_tf32.cuh) reorders the 8
terms inside one step, which the model below sums exactly, so it changes
nothing here; chip_smoke.py phase 3 checks it on the card.
A product is a sequence of 8-deep steps (wgmma m64nNk8); in split TF32
each f32 operand x is big = rna(x), small = rna(x - big) (rna: to TF32,
nearest, ties away from zero; the hardware reads only the top 19 bits of
an operand, which rna leaves set) and each step is three products, small
big, big small, big big, into a fresh accumulator, whose sum is then added
to the running f32 sum (to nearest). The fresh accumulator (_CHAIN) takes
four steps of a score (32 of the head's columns: a wgmma panel; one step
in the backward at D = 64 and 128) and, of an
output product, the steps of its tile (D = 64 and 128) or eight (64 keys
or queries, from D = 192). One product is modelled as its exact sum (TF32
products are exact in float64) added to the step's accumulator and
rounded toward zero to f32: the tensor cores' rounding, which the card
showed when the products were chained on the running sum
(csrc/mma_tf32.cuh). Their alignment of the terms inside one product (a
few bits past f32) is not modelled; chip_smoke.py phase 3 holds the card
to the same bounds. The row sums and delta are f32 sums in numpy's order,
not the kernels'. At N = 2048, D = 256 (the f32 `num_heads: 1` path) the
same emulation lands at 0.39-0.53 of the bounds from float64; a fresh
accumulator over 64 columns of a score would land at 0.71-0.86, and
output products chained over their whole depth 2.4x outside them.
"""

import ast
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from vae_song_tpu.ops import denseattn as jax_denseattn

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "chip_smoke.py")
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


def _smoke_constant(name):
    """The literal value chip_smoke.py assigns to its constant `name`."""
    with open(SMOKE) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets):
                return ast.literal_eval(node.value)
    raise KeyError(name)


# chip_smoke.py's bounds of the card's f32 kernels against their plain
# versions: O within K1_F32_TOL (packed route) or K3_F32_O_TOL (BHND
# route) of max(1, max|O|), LSE2 within K1_F32_TOL of max(1, max|LSE2|),
# each gradient within K2_F32_TOL of its max|d|.
K1_F32_TOL = _smoke_constant("K1_F32_TOL")
K3_F32_O_TOL = _smoke_constant("K3_F32_O_TOL")
K2_F32_TOL = _smoke_constant("K2_F32_TOL")

# Above D = 256 chip_smoke.py holds the gradients to K3_F32_WIDE_TOL.
K3_F32_WIDE_TOL = _smoke_constant("K3_F32_WIDE_TOL")

# route: (B, N, H, D, bound on O); the packed route's 64-wide heads in a
# pair, the BHND route's one head of 128, and the wgmma kernels' widths from
# 192: 192 and 256 (the f32 `num_heads: 1` SetVAE step's 256; N = 192, a
# last 128-row tile half past N), 512 (phase 3's B = 8 and B = 1 width)
# and 576 (a last 128-column tile half past D)
ROUTES = {"packed": (2, 128, 2, 64, K1_F32_TOL), "bhnd": (2, 128, 1, 128, K3_F32_O_TOL),
          "bhnd192": (2, 128, 1, 192, K3_F32_O_TOL), "bhnd256": (1, 192, 1, 256, K3_F32_O_TOL),
          "bhnd512": (1, 128, 1, 512, K3_F32_O_TOL), "bhnd576": (1, 128, 1, 576, K3_F32_O_TOL)}


def _grad_tol(d):
    """chip_smoke.py's bound on the f32 gradients at head width d."""
    return K2_F32_TOL if d <= 256 else K3_F32_WIDE_TOL


def _key_tile(d):
    """Keys of a tile of the forward at D = 64 or 128 (a ring stage)."""
    return 64 if d == 64 else 32


def _query_tile(d):
    """Queries of a tile of the dK/dV kernel at D = 64 or 128 (each tile's
    dV and dK one fresh accumulator)."""
    return 64 if d == 64 else 32


# 8-deep steps a fresh accumulator takes: a score's 32-column wgmma panel
# (one step in the backward's S^T and dP^T at D = 64 and 128); an output
# product's two panels of 32 keys or queries from D = 192
# (dense_attn_tf32_wide.cu) and in the dQ product at 64 and 128.
_CHAIN = {"score": 4, "score_bwd": 1, "product": 8}


def _rna(x):
    """x (f32) rounded to TF32, to nearest with ties away from zero, as f32
    with the low 13 bits clear: the kernels' tf32_rna, cvt.rna.tf32.f32."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _rz(x):
    """float64 to f32, rounded toward zero."""
    r = x.astype(np.float32)
    up = np.abs(r.astype(np.float64)) > np.abs(x)
    r[up] = np.nextafter(r[up], np.float32(0))
    return r


def _mma(c, a, b, split, chain=1):
    """c + a @ b the kernels' way: c [..., M, N] f32, a [..., M, K], b
    [..., K, N] f32, K a multiple of 8 chain. In split TF32 (`split`)
    three products a step of 8 (small big, big small, big big), else one
    of the rna-rounded operands (one-pass TF32), into a fresh accumulator
    (each product's exact sum added to it, rounded toward zero) that takes
    `chain` steps and is then added to c in f32."""
    if split:
        ab, bb = _rna(a), _rna(b)
        pairs = ((_rna(a - ab), bb), (ab, _rna(b - bb)), (ab, bb))
    else:
        pairs = ((_rna(a), _rna(b)),)
    c = np.asarray(c, np.float32)
    for c0 in range(0, a.shape[-1], 8 * chain):
        d = np.zeros(c.shape, np.float32)
        for k0 in range(c0, c0 + 8 * chain, 8):
            for x, y in pairs:
                step = (x[..., k0:k0 + 8].astype(np.float64)
                        @ y[..., k0:k0 + 8, :].astype(np.float64))
                d = _rz(d.astype(np.float64) + step)
        c = c + d
    return c


def _qc(q, scale):
    # qscale is rounded to f32 (the C entry point's float), then one f32 multiply
    return q * np.float32(scale * LOG2E)


def _scores(a, bt, split, chain=None):
    """a @ bt^T ([..., M, D] by [..., T, D]) the kernels' way: a fresh
    accumulator each `chain` 8-deep steps of the head (a 32-column panel
    unless given), added in column order."""
    return _mma(np.zeros(a.shape[:-1] + bt.shape[-2:-1], np.float32), a, bt.swapaxes(-1, -2),
                split, chain or _CHAIN["score"])


def _fwd_wide(q, k, v, scale, split):
    """The forward kernels from D = 192 on [BH, N, D] f32: (O, LSE2)."""
    qc = _qc(q, scale)
    s = _mma(np.zeros(q.shape[:-1] + k.shape[-2:-1], np.float32), qc, k.swapaxes(-1, -2), split,
             _CHAIN["score"])
    m = s.max(axis=-1)
    p = np.exp2(s - m[..., None])
    l = p.sum(axis=-1, dtype=np.float32)
    o = _mma(np.zeros(q.shape, np.float32), p, v, split, _CHAIN["product"])
    return o / l[..., None], m + np.log2(l)


def _bwd_wide(q, k, v, o, lse, do, scale, split):
    """The backward kernels from D = 192 on [BH, N, D] f32: (dq, dk, dv)."""
    qc = _qc(q, scale)
    delta = (do * o).sum(axis=-1, dtype=np.float32)
    scores = lambda a, b: _mma(np.zeros(a.shape[:-1] + b.shape[-2:-1], np.float32), a,
                               b.swapaxes(-1, -2), split, _CHAIN["score"])
    product = lambda a, b: _mma(np.zeros(b.shape, np.float32), a, b, split, _CHAIN["product"])
    pt = np.exp2(scores(k, qc) - lse[:, None, :])   # keys by queries
    dst = pt * (scores(v, do) - delta[:, None, :])
    dq = product(np.ascontiguousarray(dst.swapaxes(-1, -2)), k)
    return dq * np.float32(scale), product(dst, qc) * np.float32(LN2), product(pt, do)


def _fwd(q, k, v, scale, split):
    """The forward kernel on [BH, N, D] f32: (O, LSE2 [BH, N])."""
    bh, n, d = q.shape
    if d >= 192:
        return _fwd_wide(q, k, v, scale, split)
    t = _key_tile(d)
    qc = _qc(q, scale)
    acc = np.zeros((bh, n, d), np.float32)
    m = np.full((bh, n), -np.inf, np.float32)
    l = np.zeros((bh, n), np.float32)
    for t0 in range(0, n, t):
        s = _scores(qc, k[:, t0:t0 + t], split)
        mn = np.maximum(m, s.max(axis=-1))
        alpha = np.exp2(m - mn)
        p = np.exp2(s - mn[..., None])
        l = l * alpha + p.sum(axis=-1, dtype=np.float32)
        # the tile's P V in one fresh accumulator, added to O alpha
        acc = _mma(acc * alpha[..., None], p, v[:, t0:t0 + t], split, t // 8)
        m = mn
    return acc / l[..., None], m + np.log2(l)


def _bwd(q, k, v, o, lse, do, scale, split):
    """The backward kernels on [BH, N, D] f32: (dq, dk, dv)."""
    bh, n, d = q.shape
    if d >= 192:
        return _bwd_wide(q, k, v, o, lse, do, scale, split)
    t = _query_tile(d)
    qc = _qc(q, scale)
    delta = (do * o).sum(axis=-1, dtype=np.float32)
    zeros = lambda *shape: np.zeros(shape, np.float32)
    dk, dv, dst = zeros(bh, n, d), zeros(bh, n, d), zeros(bh, n, n)
    for t0 in range(0, n, t):   # dK/dV: every key against a tile of queries
        qt, dot = qc[:, t0:t0 + t], do[:, t0:t0 + t]
        pt = np.exp2(_scores(k, qt, split, _CHAIN["score_bwd"]) - lse[:, None, t0:t0 + t])
        dpt = _scores(v, dot, split, _CHAIN["score_bwd"])
        dst[..., t0:t0 + t] = pt * (dpt - delta[:, None, t0:t0 + t])
        dv = _mma(dv, pt, dot, split, t // 8)
        dk = _mma(dk, dst[..., t0:t0 + t], qt, split, t // 8)
    # dQ = dS K from dS^T, a fresh accumulator each 64 keys
    dq = _mma(zeros(bh, n, d), np.ascontiguousarray(dst.swapaxes(-1, -2)), k, split,
              _CHAIN["product"])
    return dq * np.float32(scale), dk * np.float32(LN2), dv


def _fwd64(q, k, v, scale):
    """The same function in float64 from the f32 qc."""
    qc, k, v = _qc(q, scale).astype(np.float64), k.astype(np.float64), v.astype(np.float64)
    s = qc @ k.transpose(0, 2, 1)
    m = s.max(axis=-1, keepdims=True)
    p = np.exp2(s - m)
    l = p.sum(axis=-1)
    return (p @ v) / l[..., None], m[..., 0] + np.log2(l)


def _bwd64(q, k, v, o, lse, do, scale):
    """The backward in float64 from the same f32 inputs (O and LSE2 those
    given), qc rounded to f32."""
    qc = _qc(q, scale).astype(np.float64)
    k, v, o, do, lse = (a.astype(np.float64) for a in (k, v, o, do, lse))
    p = np.exp2(qc @ k.transpose(0, 2, 1) - lse[..., None])
    ds = p * (do @ v.transpose(0, 2, 1) - (do * o).sum(axis=-1)[..., None])
    return ds @ k * scale, ds.transpose(0, 2, 1) @ qc * LN2, p.transpose(0, 2, 1) @ do


def _to_bh(a, b, n, h, d):
    """[B, N, H * D] or [B, N, H, D] -> [B H, N, D]."""
    return np.ascontiguousarray(
        np.asarray(a, np.float32).reshape(b, n, h, d).transpose(0, 2, 1, 3).reshape(b * h, n, d))


def _jax(route, q, k, v, do, scale):
    """The JAX package's f32 kernels of `route` (interpret mode) on
    [B, N, H, D] inputs: O, LSE2, (dq, dk, dv), all [B H, N(, D)]."""
    b, n, h, d = q.shape
    if route == "packed":
        q2, k2, v2, do2 = (jnp.asarray(a.reshape(b, n, h * d)) for a in (q, k, v, do))
        o, lse_a, lse_b = jax_denseattn._call_fwd_packed(q2, k2, v2, scale, True)
        grads = jax_denseattn._call_bwd_packed(q2, k2, v2, do2, o, lse_a, lse_b, scale, True)
        lse = jnp.stack([lse_a[..., 0], lse_b[..., 0]], axis=2).reshape(b, h, n)
    else:
        bhnd = lambda a: jnp.asarray(a.transpose(0, 2, 1, 3))
        qb, kb, vb, dob = (bhnd(a) for a in (q, k, v, do))
        o, lse4 = jax_denseattn._call_fwd(qb, kb, vb, scale, True)
        grads = jax_denseattn._call_bwd(qb, kb, vb, dob, o, lse4, scale, True)
        lse = lse4[..., 0]
        o, grads = o.transpose(0, 2, 1, 3), [g.transpose(0, 2, 1, 3) for g in grads]
    bh = lambda a: _to_bh(a, b, n, h, d)
    return bh(o), np.asarray(lse, np.float32).reshape(b * h, n), [bh(g) for g in grads]


@functools.lru_cache(maxsize=None)
def _case(route):
    """Inputs from a numpy seed and every side's results for `route`."""
    b, n, h, d, _ = ROUTES[route]
    rng = np.random.default_rng(15 + d)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    q, k, v, do = ((rng.normal(size=(b, n, h, d)) * s).astype(np.float32)
                   for s in (2.0, 2.0, 1.0, 1.0))
    scale = 1.0 / np.sqrt(d)
    qh, kh, vh, doh = (_to_bh(a, b, n, h, d) for a in (q, k, v, do))
    out = {"jax": _jax(route, q, k, v, do, scale)}
    o64, lse64 = _fwd64(qh, kh, vh, scale)
    for name, split in (("split", True), ("one_pass", False)):
        o, lse = _fwd(qh, kh, vh, scale, split)
        grads = _bwd(qh, kh, vh, o, lse, doh, scale, split)
        out[name] = (o, lse, grads)
        out[name + "64"] = (o64, lse64, _bwd64(qh, kh, vh, o, lse, doh, scale))
    return out


def _misses(got, ref, o_tol):
    """Each quantity's error over its bound: O, LSE2, dq, dk, dv."""
    (o, lse, grads), (o_ref, lse_ref, g_ref) = got, ref
    g_tol = _grad_tol(o.shape[-1])
    ratios = [np.abs(o - o_ref).max() / (o_tol * max(1.0, np.abs(o_ref).max())),
              np.abs(lse - lse_ref).max() / (K1_F32_TOL * max(1.0, np.abs(lse_ref).max()))]
    ratios += [np.abs(g - w).max() / (g_tol * np.abs(w).max()) for g, w in zip(grads, g_ref)]
    return np.array(ratios)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_split_tf32_matches_jax_interpret(route, one_thread):
    out = _case(route)
    ratios = _misses(out["split"], out["jax"], ROUTES[route][4])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_split_tf32_matches_float64(route, one_thread):
    out = _case(route)
    ratios = _misses(out["split"], out["split64"], ROUTES[route][4])
    assert (ratios <= 1.0).all(), ratios


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_one_pass_tf32_misses_the_bounds(route, one_thread):
    # one TF32 product keeps about 2^-11 of each term: O, LSE2 and every
    # gradient land one to two orders of magnitude outside the bounds that
    # split TF32 meets, so the bounds tell the two apart
    out = _case(route)
    for ref in ("jax", "one_pass64"):
        ratios = _misses(out["one_pass"], out[ref], ROUTES[route][4])
        assert (ratios > 10.0).all(), (ref, ratios)


def test_rna_rounds_to_nearest_ties_away():
    rng = np.random.default_rng(3)
    wide = rng.normal(size=4096) * 10.0 ** rng.integers(-30, 30, 4096)
    x = np.concatenate([wide.astype(np.float32), np.float32([0.0, -0.0, 1.0, 3.4e38])])
    # ties: half a TF32 ulp past a TF32 value, both signs
    base = _rna(rng.normal(size=64).astype(np.float32))
    ties = (base.view(np.uint32) | np.uint32(0x1000)).view(np.float32)
    x = np.concatenate([x, ties])
    got = _rna(x).astype(np.float64)
    xd = x.astype(np.float64)
    # the two TF32 neighbours of x, from its exponent: ulp = 2^(e - 10)
    ulp = np.ldexp(1.0, np.frexp(np.abs(xd))[1] - 11)
    lo = np.floor(np.abs(xd) / ulp) * ulp
    hi = lo + ulp
    want = np.where(np.abs(xd) - lo >= hi - np.abs(xd), hi, lo) * np.sign(xd)
    ok = np.isfinite(want) & (np.abs(xd) < 3e38)
    np.testing.assert_array_equal(got[ok], want[ok])
    assert (got[len(x) - 64:] == want[len(x) - 64:]).all() and (np.abs(got[-64:]) > np.abs(base)).all()


def test_tf32_narrow_scratch_bytes_match_the_kernels():
    """The scratches the wrapper allocates for the f32 kernels at D = 64
    and 128 are the sizes the kernels carve up (csrc/dense_attn_tf32.cuh):
    forward K and V^T in two halves each; backward dS^T [B H, N, N], qc,
    dO, qc^T, dO^T and K^T in two halves each; all f32."""
    from vae_song_tpu_torch.ops import denseattn
    with open(os.path.join(os.path.dirname(SMOKE), "vae_song_tpu_torch", "csrc",
                           "dense_attn_tf32.cuh")) as f:
        text = f.read()
    assert "return 16 * bhn * D;" in text
    assert "return 4 * bhn * N + 40 * bhn * D;" in text
    for b, h, n, d in ((64, 4, 2048, 64), (64, 2, 2048, 128), (1, 4, 192, 64)):
        bhn = b * h * n
        assert denseattn.tf32_narrow_fwd_scratch_bytes(b, h, n, d) == 4 * (
            2 * bhn * d + 2 * b * h * d * n)
        assert denseattn.tf32_narrow_bwd_scratch_bytes(b, h, n, d) == 4 * (
            bhn * n + 2 * 2 * bhn * d + 3 * 2 * b * h * d * n)


def test_tf32_wide_scratch_bytes_match_the_kernels():
    """The scratches the wrapper allocates for the f32 kernels from D = 192
    are the sizes the kernels carve up (csrc/dense_attn_tf32_wide.cuh):
    forward S2 [B H, N, N], the 128-key tiles' row maxima [B H N, ceil(N /
    128)], K and V^T in two halves each; backward P^T and dS^T [B H, N,
    N], qc, dO, qc^T, dO^T and K^T in two halves each; all f32."""
    from vae_song_tpu_torch.ops import denseattn
    with open(os.path.join(os.path.dirname(SMOKE), "vae_song_tpu_torch", "csrc",
                           "dense_attn_tf32_wide.cuh")) as f:
        text = f.read()
    assert "return 4 * bhn * N + 4 * bhn * ((N + 127) / 128) + 16 * bhn * D;" in text
    assert "return 8 * bhn * N + 40 * bhn * D;" in text
    for b, h, n, d in ((64, 1, 2048, 256), (2, 3, 192, 576), (8, 1, 2048, 512)):
        bhn = b * h * n
        assert denseattn.tf32_fwd_scratch_bytes(b, h, n, d) == 4 * (
            bhn * n + bhn * -(-n // 128) + 2 * bhn * d + 2 * b * h * d * n)
        assert denseattn.tf32_bwd_scratch_bytes(b, h, n, d) == 4 * (
            2 * bhn * n + 2 * 2 * bhn * d + 3 * 2 * b * h * d * n)
