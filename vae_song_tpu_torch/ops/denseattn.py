"""Dense attention: the port of vae_song_tpu/ops/denseattn.py's kernels
to hand-written Hopper kernels (csrc/dense_attn_fwd.cu,
csrc/dense_attn_bwd.cu), each with its plain PyTorch version beside it.
Two routes share one kernel pair:

  * the packed route (`dense_attention_fwd`, the JAX package's
    `_fwd_kernel_packed` K1 and `_bwd_kernel_packed` K2): shapes that
    `packed_ok` accepts, 64-wide heads in an even count;
  * the BHND route (`dense_attention_bhnd` and `dense_attention`, the
    JAX package's `_fwd_kernel` K3f and `_bwd_kernel` K3b): the other
    shapes `dense_ok` accepts, head widths D % 64 == 0 other than 64 or
    an odd head count.

The JAX kernels of both routes compute the same function with the same
roundings, so the port launches one kernel for both, at every head width
D % 64 == 0 that `dense_ok` accepts; each route counts its own launches.
In bf16 at D = 64 to 256 (every configured path) the forward is one
wgmma kernel fed by TMA (csrc/dense_attn_fwd.cu), and the backward a
preprocess pass that writes delta and qc into scratch that `_launch_bwd`
allocates, then a wgmma kernel pair (csrc/dense_attn_bwd.cu). At D = 192
and 256 (`num_heads: 1` at d_model 256) the forward walks 64-key tiles,
so that O at full width fits a thread's registers, and the backward's
two consumer warpgroups split the scores (one computes S and P, the
other dP, and they swap them through shared memory) and the head's
columns of dK, dV and dQ: each product once per tile pair, 14 B H N^2 D
against the bound's 10 (counted apart in `wgmma_wide_fwd.launches` and
`wgmma_wide_bwd.launches` as well). In f32
(`mixed_precision: false`) every product is split TF32 on the tensor
cores' wgmma (each operand as two TF32 halves, three TF32 products a
product: f32-accurate, in place of the f32 FMA units' 67 TFLOP/s), and
the backward's preprocess writes delta only. At D = 64 and 128 (the f32
SetVAE path's four heads of 64, and two of 128) csrc/dense_attn_tf32.cu
keeps the scores on chip: a pre-pass splits K and V^T (keys permuted in
groups of 8, so that P in the accumulator layout is the A operand of P V
as it stands), the forward is one kernel with an online softmax, the
backward a dK/dV kernel that forms S^T, P^T, dP^T and dS^T on chip and
writes dS^T to an f32 scratch, from which a product makes dQ: 4 B H N^2 D
forward, 10 backward (`tf32_narrow_fwd_scratch_bytes`: 0.54 GB at B =
64, H = 4, N = 2048, D = 64; `tf32_narrow_bwd_scratch_bytes`: 5.6 GB);
counted apart in `tf32_narrow_fwd.launches` and `tf32_narrow_bwd.launches`
as well. tests/test_torch_denseattn_f32split.py emulates both kernels'
order of work in numpy on the CPU; chip_smoke.py phase 3 and
scripts/ab_attn_f32.py hold them to their plain versions and to float64
on the card. f32 heads of 192 and wider take
the split-TF32 wgmma/TMA kernels of csrc/dense_attn_tf32_wide.cu, products
over written-out scores: a pre-pass splits the B operands (K and V^T
forward; qc, dO, qc^T, dO^T, K^T backward) into TF32 halves laid out
K-major (TF32 wgmma has no transpose), S2 = qc K^T goes to an f32
scratch with each 128-key tile's row maxima, and O = P V takes P =
exp2(S2 - m) as it loads S2; the backward writes P^T and dS^T out and
makes dV, dK and dQ as products: 4 B H N^2 D forward, 10 backward.
`_launch_fwd` and `_launch_bwd` allocate their scratches
(`tf32_fwd_scratch_bytes`: 1.6 GB at B = 64, N = 2048, D = 256;
`tf32_bwd_scratch_bytes`: 3.5 GB); counted apart in
`tf32_wide_fwd.launches` and `tf32_wide_bwd.launches` as well.
bf16 heads of 320 to 512 (`num_heads: 1` at d_model 320 to 512) take
wgmma kernels fed by TMA through rings of 64-column panels: the
forward's two consumer warpgroups each sum the scores over half the
head's panels and swap the partial sums through shared memory (f32
addition commutes, so both hold the same S), then each accumulates O on
its half of the columns, every product once (4 B H N^2 D); the backward's
dK/dV kernel splits the scores as at 192 and 256 (one warpgroup S and P,
the other dP) in column groups of at most 256, each recomputing S and dP
over the head, and its dQ kernel takes the whole head: 18 B H N^2 D at
D = 512 (counted apart in `wgmma_wider_fwd.launches` and
`wgmma_wider_bwd.launches` as well). bf16 heads of 576 to 2048
(`num_heads: 1` at d_model 576 to 2048) take wgmma kernels run by a
thread-block cluster of 3, 4 or 8 CTAs that splits the head: CTA r
holds 2 to 4 of its 64-column panels, computes the partial scores over
them, and the cluster sums each score tile over its CTAs through
distributed shared memory in one fixed order (rank order), so every CTA
holds the same scores and the same softmax; each CTA then accumulates O
(or dK and dV) on its own panels. The dK/dV kernel hands dS^T to the dQ
kernel through a bf16 scratch of [B H, N, N] that `_launch_bwd`
allocates, so every product is made once: 4 B H N^2 D forward, 10 B H
N^2 D backward (counted apart in `wgmma_cluster_fwd.launches` and
`wgmma_cluster_bwd.launches` as well).
bf16 heads wider than 2048 (`num_heads: 1` at d_model 2112 and up) take
the wgmma/TMA kernels of csrc/dense_attn_scores.cu, which write the
scores out: the dense gate caps N at 2048, so there D > N and one head's
[N, N] scores are smaller than its q [N, D], while a block can hold
neither a tile of q nor a row block's output at that width. The forward
is qc, then S2 = qc k^T into an f32 scratch, a row pass (the exact row
max, P into a bf16 scratch, 1 / l and LSE2) and O = P V, each product a
grid of 128 x 128 tiles fed by TMA through a ring of 64-deep stages; the
backward writes P^T and dS^T into bf16 scratches from one kernel that
computes S^T and dP^T for the same tile, then dV = P^T dO, dK = ln2 dS^T
qc and dQ = scale dS K (the cluster route's dQ kernel) are products of
their own: 4 B H N^2 D forward, 10 B H N^2 D backward, each product made
once. `_launch_fwd` allocates the forward's scratch
(`scores_fwd_scratch_bytes`: 2.2 GB at B = 64, N = 2048, D = 2304),
`_launch_bwd` the backward's two [B H, N, N] bf16 scratches (1 GiB);
counted apart in `wgmma_scores_fwd.launches` and
`wgmma_scores_bwd.launches` as well.

The forward computes, per (batch, head):

    qc   = round_to_input_dtype(q * scale * log2e)
    S2   = qc k^T                          (f32 accumulation)
    m    = rowmax(S2)                      (exact, never a bound)
    P    = exp2(S2 - m)                    (bf16 inputs: argument and
                                            result rounded to bf16)
    O    = (P v) / rowsum(P)               (row sum of the rounded P, f32)
    LSE2 = m + log2(rowsum(P))             (base-2 residual, f32)

q, k, v are [B, N, H, D] and may be views of the model's packed
[B, N, H*D] projections: the kernel reads them through strides, so no
transposes are made (the JAX BHND route transposes to [B, H, N, D]; the
result is the same). O comes back as [B, N, H, D] (contiguous, so it
reshapes to [B, N, H*D] for free) and LSE2 as [B, H, N]; the JAX packed
kernel's `lse_a` / `lse_b` [B, H/2, N, 1] are heads 2j and 2j + 1 of it,
its BHND kernel's [B, H, N, 1] is it.

The kernels up to D = 2048 keep an online softmax (running exact max), so
under bf16 they round P against the running max where the plain version
and the TPU kernels use the final row max: the two agree within bf16
rounding. The kernels for wider heads take the whole-row max, as the
plain version does.

The backward recomputes P from LSE2 and follows the TPU kernels'
roundings (cd = bf16 for bf16 inputs, f32 for f32 inputs):

    P     = exp2(round_cd(qc k^T - LSE2)), rounded to cd
    dV    = P^T dO,  dP = round_cd(dO v^T),  delta = round_cd(rowsum(dO O))
    dS    = round_cd(P * round_cd(dP - delta))
    dQ    = (dS k) * scale,  dK = (dS^T qc) * ln2   (f32 sums, cast at the end)

Both routes are differentiable through one torch.autograd.Function whose
forward and backward are the kernels on CUDA tensors (the plain versions
on CPU tensors). It saves q, k, v, O and LSE only when a gradient will be
asked for.
"""

import ctypes
import types

import torch

from vae_song_tpu_torch import _kernels

# dense_ok / packed_ok gates of the JAX package (denseattn.py:372-378,
# 709-714)
MAX_DENSE_SEQ = 2048
HEAD_DIM = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# query rows per plain-version chunk: bounds the f32 [chunk, H, N, N]
# score tensor (1 GiB at N = 2048, H = 4, chunk = 16)
_PLAIN_BATCH_CHUNK = 16


def dense_ok(n_q: int, n_kv: int, head_dim: int) -> bool:
    """The JAX package's gate for its dense (BHND) kernel."""
    return (
        n_q == n_kv
        and n_q <= MAX_DENSE_SEQ
        and n_q % 128 == 0
        and head_dim % 64 == 0
    )


def packed_ok(n_q: int, n_kv: int, num_heads: int, head_dim: int) -> bool:
    """The JAX package's gate for its packed kernel."""
    return dense_ok(n_q, n_kv, head_dim) and head_dim == HEAD_DIM and num_heads % 2 == 0


def _check(q, k, v):
    if not (q.shape == k.shape == v.shape) or q.dim() != 4:
        raise ValueError(
            f"q, k, v must share one [B, N, H, D] shape, got "
            f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q, k, v must all be float32 or all bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k, v must lie on one device")
    b, n, h, d = q.shape
    if d % 64 != 0 or d == 0:
        raise ValueError(f"head width must be a positive multiple of 64, got {d}")
    if n % 64 != 0 or n == 0:
        raise ValueError(f"sequence length must be a positive multiple of 64, got {n}")


def dense_attention_fwd_plain(q, k, v, scale: float):
    """Plain PyTorch version of the kernel: same function, same roundings,
    whole-row max. Returns (o [B, N, H, D] in q's dtype, lse [B, H, N] f32)."""
    _check(q, k, v)
    dt = q.dtype
    qc = (q.float() * (scale * LOG2E)).to(dt)
    outs, lses = [], []
    for s0 in range(0, q.shape[0], _PLAIN_BATCH_CHUNK):
        sl = slice(s0, s0 + _PLAIN_BATCH_CHUNK)
        s = torch.einsum("bqhd,bkhd->bhqk", qc[sl].float(), k[sl].float())
        m = s.amax(dim=-1, keepdim=True)
        # bf16: exp2 of the rounded argument, rounded once (no-ops in f32)
        p = torch.exp2((s - m).to(dt).float()).to(dt)
        o = torch.einsum("bhqk,bkhd->bqhd", p.float(), v[sl].float())
        l = p.float().sum(dim=-1)                          # [b, H, N]
        outs.append((o / l.permute(0, 2, 1)[..., None]).to(dt))
        lses.append(m[..., 0] + torch.log2(l))
    return torch.cat(outs), torch.cat(lses)


def _check_kernel_operands(q, k, v):
    _kernels.check_device(q)
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride() != q.stride():
            raise ValueError(f"{name} must have q's strides {q.stride()}, got {t.stride()}")
        if t.data_ptr() % 16 != 0:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    sb, sn, sh, sd = q.stride()
    if sd != 1 or sb % 8 or sn % 8 or sh % 8:
        raise ValueError(
            f"q/k/v need unit stride on D and batch/row/head strides that are "
            f"multiples of 8 elements, got {q.stride()}"
        )


def scores_fwd_scratch_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the forward scratch of the kernels for bf16 heads wider
    than 2048 (csrc/dense_attn_scores.cuh: attn_scores_fwd_scratch): S2
    f32 and P bf16 [B H, N, N], qc bf16 [B, N, H, D], 1 / l f32 [B H, N]."""
    bhn = b * h * n
    return 6 * bhn * n + 2 * bhn * d + 4 * bhn


def tf32_fwd_scratch_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the forward scratch of the f32 kernels for heads of 192
    and wider (csrc/dense_attn_tf32_wide.cuh: attn_tf32_fwd_scratch): S2
    f32 [B H, N, N], each 128-key tile's row maxima f32 [B H N, ceil(N /
    128)], the split halves of K [B H, N, D] and of V^T [B H, D, N]."""
    bhn = b * h * n
    return 4 * bhn * n + 4 * bhn * (-(-n // 128)) + 16 * bhn * d


def tf32_narrow_fwd_scratch_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the forward scratch of the f32 kernels for heads of 64 and
    128 (csrc/dense_attn_tf32.cuh: attn_tf32_narrow_fwd_scratch): the split
    halves of K [B H, N, D] and of V^T [B H, D, N]."""
    bhn = b * h * n
    return 16 * bhn * d


def tf32_narrow_bwd_scratch_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the backward scratch of the same kernels
    (attn_tf32_narrow_bwd_scratch): dS^T f32 [B H, N, N], the split halves
    of qc and dO [B H, N, D] and of qc^T, dO^T, K^T [B H, D, N]."""
    bhn = b * h * n
    return 4 * bhn * n + 40 * bhn * d


def tf32_bwd_scratch_bytes(b: int, h: int, n: int, d: int) -> int:
    """Bytes of the backward scratch of the same kernels
    (attn_tf32_bwd_scratch): P^T and dS^T f32 [B H, N, N], the split
    halves of qc and dO [B H, N, D] and of qc^T, dO^T, K^T [B H, D, N]."""
    bhn = b * h * n
    return 8 * bhn * n + 40 * bhn * d


def _launch_fwd(q, k, v, scale):
    _check_kernel_operands(q, k, v)
    b, n, h, d = q.shape
    sb, sn, sh, _ = q.stride()
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    # the kernels for bf16 heads wider than 2048 and for f32 heads of 192
    # and wider write the scores out; the f32 kernels split their B operands
    nbytes = (scores_fwd_scratch_bytes(b, h, n, d) if wgmma_scores(q.dtype, d)
              else tf32_fwd_scratch_bytes(b, h, n, d) if tf32_wide(q.dtype, d)
              else tf32_narrow_fwd_scratch_bytes(b, h, n, d) if tf32_narrow(q.dtype, d) else 0)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=q.device) if nbytes else None
    ob, on, oh, _ = o.stride()
    _kernels.launch(
        "vst_dense_attn_fwd", q.device,
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), None if scratch is None else scratch.data_ptr(),
        b, h, n, d, sb, sn, sh, ob, on, oh, float(scale * LOG2E),
    )
    return o, lse


def attn_bwd_preprocess_plain(q, o, do, scale: float):
    """Plain PyTorch version of the backward's preprocess pass: (qc
    [B, N, H, D] in q's dtype, delta [B, H, N] f32), with
    qc = round_to_input_dtype(q * scale * log2e) and
    delta = round_cd(rowsum(dO * O)) (f32 sum)."""
    dt = q.dtype
    qc = (q.float() * (scale * LOG2E)).to(dt)
    delta = (do.float() * o.float()).sum(dim=-1).to(dt).float()
    return qc, delta.permute(0, 2, 1)


def dense_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain PyTorch version of the backward kernel: same function, same
    roundings. q, k, v, o, do [B, N, H, D] in one dtype, lse [B, H, N]
    f32 (the forward's). Returns (dq, dk, dv) [B, N, H, D] in q's dtype."""
    _check(q, k, v)
    dt = q.dtype
    rd = lambda t: t.to(dt).float()                       # round to cd
    qc, delta = attn_bwd_preprocess_plain(q, o, do, scale)
    dqs, dks, dvs = [], [], []
    for s0 in range(0, q.shape[0], _PLAIN_BATCH_CHUNK):
        sl = slice(s0, s0 + _PLAIN_BATCH_CHUNK)
        qf, kf, vf, dof = qc[sl].float(), k[sl].float(), v[sl].float(), do[sl].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        p = rd(torch.exp2(rd(s - lse[sl][..., None])))
        dp = rd(torch.einsum("bqhd,bkhd->bhqk", dof, vf))
        ds = rd(p * rd(dp - delta[sl][..., None]))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof).to(dt))
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(dt))
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, qf) * LN2).to(dt))
    return torch.cat(dqs), torch.cat(dks), torch.cat(dvs)


def _launch_bwd(q, k, v, o, lse, do, scale):
    _check_kernel_operands(q, k, v)
    b, n, h, d = q.shape
    if o.dtype != q.dtype or do.dtype != q.dtype:
        raise TypeError(f"o and dO must be {q.dtype}, got {o.dtype}, {do.dtype}")
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, n):
        raise ValueError("o and dO must be [B, N, H, D] and lse [B, H, N]")
    # O comes contiguous from the forward kernel; dO from autograd may
    # not: one stated copy gives it O's layout
    o, do, lse = o.contiguous(), do.contiguous(), lse.float().contiguous()
    dq, dk, dv = (torch.empty_like(o) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    # the bf16 kernels read qc from a scratch in O's layout, written by
    # their preprocess pass; the cluster kernels for heads of 576 to 2048
    # hand dS^T from the dK/dV kernel to the dQ kernel through a scratch
    # of [B H, N, N] bf16 (512 MiB at B = 64, H = 1, N = 2048), and the
    # kernels for wider heads write P^T and dS^T into two such scratches;
    # the f32 kernels take theirs in its place (dS^T and the split operands)
    qc = torch.empty_like(o) if q.dtype == torch.bfloat16 else None
    tiles = 2 if wgmma_scores(q.dtype, d) else 1 if wgmma_cluster(q.dtype, d) else 0
    f32_bytes = (tf32_bwd_scratch_bytes(b, h, n, d) if tf32_wide(q.dtype, d)
                 else tf32_narrow_bwd_scratch_bytes(b, h, n, d) if tf32_narrow(q.dtype, d)
                 else 0)
    ds = (torch.empty((tiles * b * h, n, n), dtype=torch.bfloat16, device=q.device)
          if tiles else
          torch.empty(f32_bytes, dtype=torch.uint8, device=q.device) if f32_bytes else None)
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    _kernels.launch(
        "vst_dense_attn_bwd", q.device,
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        None if qc is None else qc.data_ptr(), None if ds is None else ds.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, d, sb, sn, sh, ob, on, oh,
        float(scale * LOG2E), float(scale),
    )
    return dq, dk, dv


# Launches of the f32 kernels for heads of 64 and 128
# (csrc/dense_attn_tf32.cu), which either route's wrapper may take; each is
# also counted on its route's wrapper.
tf32_narrow_fwd = types.SimpleNamespace(launches=0)
tf32_narrow_bwd = types.SimpleNamespace(launches=0)


def tf32_narrow(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    csrc/dense_attn_tf32.cu: the dispatch's rule, f32 and D = 64 or 128."""
    return dtype == torch.float32 and d in (64, 128)


# Launches of the f32 kernels for heads of 192 and wider
# (csrc/dense_attn_tf32_wide.cu), which either route's wrapper may take;
# each is also counted on its route's wrapper.
tf32_wide_fwd = types.SimpleNamespace(launches=0)
tf32_wide_bwd = types.SimpleNamespace(launches=0)


def tf32_wide(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    csrc/dense_attn_tf32_wide.cu: the dispatch's rule, f32 and D >= 192."""
    return dtype == torch.float32 and d >= 192


# Launches of the bf16 wgmma kernels for heads of 192 and 256 (the 64-key
# forward and the backward whose warpgroups split the scores), which
# either route's wrapper may take; each is also counted on its route's
# wrapper.
wgmma_wide_fwd = types.SimpleNamespace(launches=0)
wgmma_wide_bwd = types.SimpleNamespace(launches=0)


def wgmma_wide(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    the bf16 wgmma kernels for heads of 192 and 256: the dispatch's rule."""
    return dtype == torch.bfloat16 and d in (192, 256)


# Launches of the bf16 wgmma kernels for heads of 320 to 512 (the forward
# and backward whose warpgroups split the scores and the head's columns),
# which either route's wrapper may take; each is also counted on its
# route's wrapper.
wgmma_wider_fwd = types.SimpleNamespace(launches=0)
wgmma_wider_bwd = types.SimpleNamespace(launches=0)


def wgmma_wider(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    the bf16 wgmma kernels for heads of 320 to 512: the dispatch's rule."""
    return dtype == torch.bfloat16 and 256 < d <= 512


# Launches of the bf16 cluster kernels for heads of 576 to 2048 (a
# thread-block cluster splits the head's columns and sums the scores over
# its CTAs), which either route's wrapper may take; each is also counted
# on its route's wrapper.
wgmma_cluster_fwd = types.SimpleNamespace(launches=0)
wgmma_cluster_bwd = types.SimpleNamespace(launches=0)
MAX_CLUSTER_HEAD = 2048


def wgmma_cluster(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    the bf16 cluster kernels for heads of 576 to 2048: the dispatch's rule
    (wider bf16 heads: `wgmma_scores`)."""
    return dtype == torch.bfloat16 and 512 < d <= MAX_CLUSTER_HEAD


# Launches of the bf16 kernels for heads wider than 2048 (wgmma/TMA
# products over written-out scores, csrc/dense_attn_scores.cu), which
# either route's wrapper may take; each is also counted on its route's
# wrapper.
wgmma_scores_fwd = types.SimpleNamespace(launches=0)
wgmma_scores_bwd = types.SimpleNamespace(launches=0)


def wgmma_scores(dtype, d: int) -> bool:
    """Whether the kernels take operands of `dtype` with heads of `d` to
    the bf16 kernels over written-out scores for heads wider than 2048:
    the dispatch's rule."""
    return dtype == torch.bfloat16 and d > MAX_CLUSTER_HEAD


def cluster_ctas(d: int) -> int:
    """The cluster kernels' cluster size at a head of `d` (P = d / 64
    panels, 9 to 32): 3 CTAs up to P = 12, 4 up to 16, 8 above, each CTA
    on 2 to 4 of the head's 64-column panels (csrc/sm90.cuh:
    cluster_ctas)."""
    p = d // 64
    return 3 if p <= 12 else 4 if p <= 16 else 8


def cluster_panels(d: int):
    """The panels [first, last) of the head that each CTA of the cluster
    holds (csrc/sm90.cuh: cluster_first), by rank."""
    p, c = d // 64, cluster_ctas(d)
    first = [r * p // c for r in range(c + 1)]
    return list(zip(first, first[1:]))


def cluster_fit(d: int, device) -> dict:
    """How many clusters of each cluster kernel at a head of `d` the card
    holds at once (cudaOccupancyMaxActiveClusters): keys fwd, dkdv."""
    fit = (ctypes.c_int * 2)()
    _kernels.launch("vst_dense_attn_cluster_fit", torch.device(device), d,
                    ctypes.addressof(fit))
    return dict(zip(("fwd", "dkdv"), fit))


def _forward(q, k, v, scale, counter):
    """The kernel on a CUDA tensor (one more launch on `counter`), the
    plain version on a CPU tensor."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return dense_attention_fwd_plain(q, k, v, scale)
    out = _launch_fwd(q, k, v, scale)
    counter.launches += 1
    if tf32_narrow(q.dtype, q.shape[-1]):
        tf32_narrow_fwd.launches += 1
    if tf32_wide(q.dtype, q.shape[-1]):
        tf32_wide_fwd.launches += 1
    if wgmma_wide(q.dtype, q.shape[-1]):
        wgmma_wide_fwd.launches += 1
    if wgmma_wider(q.dtype, q.shape[-1]):
        wgmma_wider_fwd.launches += 1
    if wgmma_cluster(q.dtype, q.shape[-1]):
        wgmma_cluster_fwd.launches += 1
    if wgmma_scores(q.dtype, q.shape[-1]):
        wgmma_scores_fwd.launches += 1
    return out


def _backward(q, k, v, o, lse, do, scale, counter):
    _check(q, k, v)
    if q.device.type == "cpu":
        return dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
    out = _launch_bwd(q, k, v, o, lse, do, scale)
    counter.launches += 1
    if tf32_narrow(q.dtype, q.shape[-1]):
        tf32_narrow_bwd.launches += 1
    if tf32_wide(q.dtype, q.shape[-1]):
        tf32_wide_bwd.launches += 1
    if wgmma_wide(q.dtype, q.shape[-1]):
        wgmma_wide_bwd.launches += 1
    if wgmma_wider(q.dtype, q.shape[-1]):
        wgmma_wider_bwd.launches += 1
    if wgmma_cluster(q.dtype, q.shape[-1]):
        wgmma_cluster_bwd.launches += 1
    if wgmma_scores(q.dtype, q.shape[-1]):
        wgmma_scores_bwd.launches += 1
    return out


def dense_attention_bwd(q, k, v, o, lse, do, scale: float):
    """Gradients (dq, dk, dv) of dense attention from the forward's o and
    lse and the output cotangent do, on the packed route (K2). CUDA
    tensors launch the Hopper kernel; CPU tensors take the plain version.
    `dense_attention_bwd.launches` counts kernel launches."""
    return _backward(q, k, v, o, lse, do, scale, dense_attention_bwd)


def dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale: float):
    """The same gradients on the BHND route (K3b): the same kernel,
    counted in `dense_attention_bwd_bhnd.launches`."""
    return _backward(q, k, v, o, lse, do, scale, dense_attention_bwd_bhnd)


class _DenseAttention(torch.autograd.Function):
    """Forward and backward kernels of one route (or their plain versions
    on the CPU): `fwd_counter` counts the forward's launches, `bwd` is the
    route's backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, save, fwd_counter, bwd):
        o, lse = _forward(q, k, v, scale, fwd_counter)
        ctx.scale, ctx.bwd = scale, bwd
        if save:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = ctx.bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None, None, None


def _apply(q, k, v, scale, fwd_counter, bwd):
    _check(q, k, v)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _DenseAttention.apply(q, k, v, scale, save, fwd_counter, bwd)


def dense_attention_fwd(q, k, v, scale: float):
    """Dense attention forward on the packed route (K1) on [B, N, H, D]
    q/k/v (float32 or bfloat16, D a multiple of 64, N a multiple of 64,
    any B >= 1). Returns (o [B, N, H, D], lse [B, H, N] f32); o is
    differentiable in q, k, v (backward: `dense_attention_bwd`), lse is
    not. CUDA tensors launch the Hopper kernel; CPU tensors take the plain
    version. `dense_attention_fwd.launches` counts kernel launches."""
    return _apply(q, k, v, scale, dense_attention_fwd, dense_attention_bwd)


def dense_attention_bhnd(q, k, v, scale: float):
    """Dense attention forward on the BHND route (K3f): q/k/v [B, N, H, D]
    as `dense_attention_fwd` takes them, any head count. Returns (o, lse)
    as `dense_attention_fwd` does; o is differentiable in q, k, v
    (backward: `dense_attention_bwd_bhnd`, K3b). CUDA tensors launch the
    Hopper kernel; CPU tensors take the plain version.
    `dense_attention_bhnd.launches` counts kernel launches."""
    return _apply(q, k, v, scale, dense_attention_bhnd, dense_attention_bwd_bhnd)


def dense_attention(q, k, v, scale: float):
    """The port of the JAX package's `dense_attention`: o [B, N, H, D] of
    `dense_attention_bhnd`, differentiable in q, k, v."""
    return dense_attention_bhnd(q, k, v, scale)[0]


for _fn in (dense_attention_fwd, dense_attention_bwd, dense_attention_bhnd,
            dense_attention_bwd_bhnd):
    _fn.launches = 0
