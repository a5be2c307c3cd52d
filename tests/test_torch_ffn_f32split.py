"""The arithmetic of the port's f32 fused FFN kernels (csrc/ffn_fwd.cu,
csrc/ffn_bwd.cu and csrc/ffn_tf32.cuh: split TF32 on mma.sync) emulated
in numpy and held, before the card runs it, to the JAX package's f32
`fused_ffn` in interpret mode and to a float64 version, within the bound
chip_smoke.py holds the card to (K6_F32_TOL of max|ref|); and a one-pass
TF32 emulation of the same kernels, which must miss that bound.

The emulation follows the kernels' order of work. Every product is a
sequence of m16n8k8 steps over its contraction in order, 8 terms a step:
each f32 operand split into big = rna(x) and small = rna(x - big), the
three products small big, big small, big big into a fresh accumulator
(each product's exact sum added to it, rounded toward zero: the tensor
cores' rounding), which is then added to the running f32 sum (rna and
the rounding toward zero are tests/test_torch_denseattn_f32split.py's).
Forward: h32 = relu(x W1^T + b1) over D, y = (h32 W2^T + b2) + x over F,
where the four steps of each 32-unit hidden chunk are added in order
into the first one's fresh accumulator, and the chunk sums into y's
running sum; where the kernel's warps hold 64 columns of y (D % 256 !=
0) into two, of the even and of the odd chunks, added at the end. Backward:
the same h32 and its mask, dh32 = (dy W2) * mask over D, dx = dh32 W1 +
dy over F; dW1 = dh32^T x and dW2 = dy^T h32 over each split's rows
(ops/ffn.py:wgrad_splits), the splits' partial tiles added by the sums
pass (L = 8 lanes under 256 parts, each adding every L-th part in order,
then the lanes in order); db1 and db2 from one partial per 64 rows: db1
the four warps' column sums of dh32 (rows g and g + 8 of a lane, then a
butterfly over the 8 row pairs) added in warp order, db2 dy's columns
summed over the rows of each residue mod 8 in order, the 8 sums then
pairwise; then the same sums pass over the partials.

Inputs: x, W1 and b1 on a coarse grid, so that x W1^T + b1 is exact in
f32 and in TF32 (every side takes the same ReLU mask); dy, W2 and b2 at
full f32 mantissa, so that every other product needs the small half of
the split. db2 is colsum(dy): no product, so the one-pass emulation
meets the bound there and is held only on the other five outputs.
"""

import ast
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vae_song_tpu.ops.ffn as jax_ffn
from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from test_torch_denseattn_f32split import _rna, _rz
from vae_song_tpu_torch.ops import ffn

SMOKE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                     "chip_smoke.py")


def _smoke_constant(name):
    """The literal value chip_smoke.py assigns to its constant `name`."""
    with open(SMOKE) as f:
        for node in ast.parse(f.read()).body:
            if isinstance(node, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == name for t in node.targets):
                return ast.literal_eval(node.value)
    raise KeyError(name)


# chip_smoke.py's bound of the card's f32 FFN kernels: each output within
# K6_F32_TOL of max|ref|
K6_F32_TOL = _smoke_constant("K6_F32_TOL")

M = 256
SHAPES = [(128, 256), (256, 512)]   # (D, F): the small models' and the shipped widths
PART_ROWS = 64                      # rows a db1 / db2 partial (ffn_bwd.cu kPartRows)
FWD_CHUNK = 32                      # hidden units a chunk of the forward (ffn_fwd.cu)
SMS = 132                           # the H100's streaming multiprocessors
OUTPUTS = ("y", "dx", "dw1", "db1", "dw2", "db2")


def _mma(c, a, b, split, run=1):
    """c + a @ b the kernels' way: c [..., M, N] f32, a [..., M, K], b
    [..., K, N] f32, K a multiple of 8 run. Each step of 8 terms: in split
    TF32 (`split`) three products (small big, big small, big big), else
    one of the rna-rounded operands (one-pass TF32), into a fresh
    accumulator (each product's exact sum added to it, rounded toward
    zero); the fresh accumulators of each `run` consecutive steps added
    in order into the first, which is then added to c in f32."""
    if split:
        ab, bb = _rna(a), _rna(b)
        pairs = ((_rna(a - ab), bb), (ab, _rna(b - bb)), (ab, bb))
    else:
        pairs = ((_rna(a), _rna(b)),)
    c = np.asarray(c, np.float32)
    for r0 in range(0, a.shape[-1], 8 * run):
        acc = None
        for k0 in range(r0, r0 + 8 * run, 8):
            d = np.zeros(c.shape, np.float32)
            for x, y in pairs:
                step = x[..., k0:k0 + 8].astype(np.float64) @ y[..., k0:k0 + 8, :].astype(
                    np.float64)
                d = _rz(d.astype(np.float64) + step)
            acc = d if acc is None else acc + d
        c = c + acc
    return c


def _y(h32, w2, split):
    """h32 W2^T the forward's way: each chunk's steps summed into the
    first's fresh accumulator, the chunks' sums into one running sum, or,
    where the output column chunk is 128 wide (D % 256 != 0), the even
    and the odd chunks' into two, added at the end."""
    (m, f), d = h32.shape, w2.shape[0]
    zeros = np.zeros((m, d), np.float32)
    chunks = [_mma(zeros, h32[:, c0:c0 + FWD_CHUNK], w2.T[c0:c0 + FWD_CHUNK], split,
                   FWD_CHUNK // 8) for c0 in range(0, f, FWD_CHUNK)]
    if d % 256 == 0:
        return _f32_sum(chunks)
    return _f32_sum(chunks[0::2]) + _f32_sum(chunks[1::2])


def _db2_part(dy):
    """The db2 partial of 64 rows: the rows of each residue mod 8 summed in
    order, then the 8 sums pairwise."""
    s = [_f32_sum(list(dy[k::8])) for k in range(8)]
    return ((s[0] + s[1]) + (s[2] + s[3])) + ((s[4] + s[5]) + (s[6] + s[7]))


def _f32_sum(parts):
    """parts[0] + parts[1] + ... in order, in f32."""
    total = np.zeros_like(parts[0], dtype=np.float32)
    for p in parts:
        total = total + p
    return total


def _sum_parts(parts):
    """The sums pass (ffn_sum_parts_kernel): lane y of L adds parts y,
    y + L, ... in order, then the L lane sums are added in order."""
    lanes = 32 if len(parts) >= 256 else 8
    sums = [_f32_sum(parts[y::lanes]) if y < len(parts) else np.zeros_like(parts[0])
            for y in range(lanes)]
    return _f32_sum(sums)


def _warp_colsum(v):
    """One warp's column sums over its 16 rows v [16, cols]: each lane adds
    its rows g and g + 8, then the butterfly over g (xor 1, 2, 4 of g)."""
    s = [v[g] + v[g + 8] for g in range(8)]
    s = [s[g] + s[g ^ 1] for g in range(8)]
    s = [s[g] + s[g ^ 2] for g in range(8)]
    return s[0] + s[4]


def _db1_part(dh):
    """The db1 partial of 64 rows: the four warps' sums in warp order."""
    w = [_warp_colsum(dh[16 * i:16 * i + 16]) for i in range(4)]
    return ((w[0] + w[1]) + w[2]) + w[3]


def _h32(x, w1, b1, split):
    """relu(x W1^T + b1), w1 [F, D] in the Dense layout (h_panel)."""
    m, f = x.shape[0], w1.shape[0]
    return np.maximum(_mma(np.zeros((m, f), np.float32), x, w1.T, split) + b1, np.float32(0))


def _emulate(x, dy, w1, b1, w2, b2, split):
    """The kernels' outputs (y, dx, dw1, db1, dw2, db2), port layout."""
    m, d = x.shape
    f = w1.shape[0]
    h32 = _h32(x, w1, b1, split)
    y = (_y(h32, w2, split) + b2) + x
    dh32 = np.where(h32 > 0, _mma(np.zeros((m, f), np.float32), dy, w2, split), np.float32(0))
    dx = _mma(np.zeros((m, d), np.float32), dh32, w1, split) + dy
    s = ffn.wgrad_splits(m, d, f, torch.float32, SMS)
    per = -(-(m // PART_ROWS) // s) * PART_ROWS
    rows = [slice(i * per, min(m, (i + 1) * per)) for i in range(s)]
    dw1 = _sum_parts([_mma(np.zeros((f, d), np.float32), dh32[r].T, x[r], split) for r in rows])
    dw2 = _sum_parts([_mma(np.zeros((d, f), np.float32), dy[r].T, h32[r], split) for r in rows])
    blocks = range(0, m, PART_ROWS)
    db1 = _sum_parts([_db1_part(dh32[r0:r0 + PART_ROWS]) for r0 in blocks])
    db2 = _sum_parts([_db2_part(dy[r0:r0 + PART_ROWS]) for r0 in blocks])
    return dict(zip(OUTPUTS, (y, dx, dw1, db1, dw2, db2)))


def _float64(x, dy, w1, b1, w2, b2):
    x, dy, w1, b1, w2, b2 = (a.astype(np.float64) for a in (x, dy, w1, b1, w2, b2))
    h = np.maximum(x @ w1.T + b1, 0)
    dh = (dy @ w2) * (h > 0)
    return dict(zip(OUTPUTS, (h @ w2.T + b2 + x, dh @ w1 + dy, dh.T @ x, dh.sum(0),
                              dy.T @ h, dy.sum(0))))


def _jax(x, dy, w1, b1, w2, b2):
    """The JAX package's f32 fused_ffn in interpret mode and its vjp, with
    the weights in its layout (W1 = w1^T [D, F], W2 = w2^T [F, D])."""
    args = [jnp.asarray(a) for a in (x, w1.T, b1, w2.T, b2)]
    y, vjp = jax.vjp(lambda *a: jax_ffn.fused_ffn(*a, interpret=True), *args)
    dx, dw1, db1, dw2, db2 = (np.asarray(g, np.float32) for g in vjp(jnp.asarray(dy)))
    return dict(zip(OUTPUTS, (np.asarray(y, np.float32), dx, dw1.T, db1, dw2.T, db2)))


def _grid(rng, shape, sd, step):
    return (np.clip(np.round(rng.normal(size=shape) * sd / step), -64, 64) * step).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _case(d, f):
    """Inputs from a numpy seed and every side's outputs at [M, d], f."""
    rng = np.random.default_rng(21 + d)
    x = _grid(rng, (M, d), 1.0, 1 / 8)
    w1 = _grid(rng, (f, d), d ** -0.5, 1 / 256)
    b1 = _grid(rng, (f,), 0.05, 1 / 2048)
    dy = rng.normal(size=(M, d)).astype(np.float32)
    w2 = (rng.normal(size=(d, f)) * f ** -0.5).astype(np.float32)
    b2 = (rng.normal(size=(d,)) * 0.05).astype(np.float32)
    args = (x, dy, w1, b1, w2, b2)
    return {"split": _emulate(*args, split=True), "one_pass": _emulate(*args, split=False),
            "jax": _jax(*args), "float64": _float64(*args),
            "masks_agree": bool(((_h32(x, w1, b1, True) > 0)
                                 == (x.astype(np.float64) @ w1.T.astype(np.float64) + b1 > 0)
                                 ).all())}


def _misses(got, ref):
    """Each output's distance from ref over the bound K6_F32_TOL max|ref|."""
    return {k: float(np.abs(got[k] - ref[k]).max() / (K6_F32_TOL * np.abs(ref[k]).max()))
            for k in OUTPUTS}


@pytest.mark.parametrize("d,f", SHAPES)
def test_split_tf32_matches_jax_interpret(d, f, one_thread):
    ratios = _misses(_case(d, f)["split"], _case(d, f)["jax"])
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("d,f", SHAPES)
def test_split_tf32_matches_float64(d, f, one_thread):
    case = _case(d, f)
    assert case["masks_agree"]
    ratios = _misses(case["split"], case["float64"])
    assert max(ratios.values()) <= 1.0, ratios


@pytest.mark.parametrize("d,f", SHAPES)
def test_one_pass_tf32_misses_the_bound(d, f, one_thread):
    # one TF32 product keeps about 2^-11 of each term: every output that
    # goes through a product with dy, W2 or h lands well outside the bound
    # split TF32 meets (db2, dy's column sums, takes no product)
    case = _case(d, f)
    for ref in ("jax", "float64"):
        ratios = _misses(case["one_pass"], case[ref])
        assert all(ratios[k] > 10.0 for k in OUTPUTS if k != "db2"), (ref, ratios)
        assert ratios["db2"] <= 1.0, (ref, ratios)
