"""Dense attention: the port of vae_song_tpu/ops/denseattn.py's packed
kernels, the forward (`_fwd_kernel_packed`, K1) and the backward
(`_bwd_kernel_packed`, K2), to hand-written Hopper kernels
(csrc/dense_attn_fwd.cu, csrc/dense_attn_bwd.cu), each with its plain
PyTorch version beside it.

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
transposes are made. O comes back as [B, N, H, D] (contiguous, so it
reshapes to [B, N, H*D] for free) and LSE2 as [B, H, N]; the JAX
kernel's `lse_a` / `lse_b` [B, H/2, N, 1] are heads 2j and 2j + 1 of it.

The kernel keeps an online softmax (running exact max), so under bf16 it
rounds P against the running max where the plain version and the TPU
kernel use the final row max: the two agree within bf16 rounding.

The backward recomputes P from LSE2 and follows the TPU kernel's
roundings (cd = bf16 for bf16 inputs, f32 for f32 inputs):

    P     = exp2(round_cd(qc k^T - LSE2)), rounded to cd
    dV    = P^T dO,  dP = round_cd(dO v^T),  delta = round_cd(rowsum(dO O))
    dS    = round_cd(P * round_cd(dP - delta))
    dQ    = (dS k) * scale,  dK = (dS^T qc) * ln2   (f32 sums, cast at the end)

`dense_attention_fwd` is differentiable: it runs through a
torch.autograd.Function whose forward is K1 and whose backward is K2 on
CUDA tensors (the plain versions on CPU tensors). It saves q, k, v, O and
LSE only when a gradient will be asked for.
"""

import torch

from vae_song_tpu_torch import _kernels

# packed_ok gate of the JAX package (denseattn.py:372-378, 709-714)
MAX_DENSE_SEQ = 2048
HEAD_DIM = 64
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
# query rows per plain-version chunk: bounds the f32 [chunk, H, N, N]
# score tensor (1 GiB at N = 2048, H = 4, chunk = 16)
_PLAIN_BATCH_CHUNK = 16


def packed_ok(n_q: int, n_kv: int, num_heads: int, head_dim: int) -> bool:
    """The JAX package's gate for the packed kernel, whose port this is."""
    return (
        n_q == n_kv
        and n_q <= MAX_DENSE_SEQ
        and n_q % 128 == 0
        and head_dim == HEAD_DIM
        and num_heads % 2 == 0
    )


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
    if d != HEAD_DIM:
        raise ValueError(f"head width must be {HEAD_DIM}, got {d}")
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


def _launch_fwd(q, k, v, scale):
    _check_kernel_operands(q, k, v)
    b, n, h, d = q.shape
    sb, sn, sh, _ = q.stride()
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    ob, on, oh, _ = o.stride()
    _kernels.launch(
        "vst_dense_attn_fwd", q.device,
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), lse.data_ptr(), b, h, n, sb, sn, sh, ob, on, oh,
        float(scale * LOG2E),
    )
    dense_attention_fwd.launches += 1
    return o, lse


def _forward(q, k, v, scale):
    if q.device.type == "cpu":
        return dense_attention_fwd_plain(q, k, v, scale)
    return _launch_fwd(q, k, v, scale)


def dense_attention_bwd_plain(q, k, v, o, lse, do, scale: float):
    """Plain PyTorch version of the backward kernel: same function, same
    roundings. q, k, v, o, do [B, N, H, D] in one dtype, lse [B, H, N]
    f32 (the forward's). Returns (dq, dk, dv) [B, N, H, D] in q's dtype."""
    _check(q, k, v)
    dt = q.dtype
    rd = lambda t: t.to(dt).float()                       # round to cd
    qc = (q.float() * (scale * LOG2E)).to(dt)
    delta = rd((do.float() * o.float()).sum(dim=-1))      # [B, N, H]
    dqs, dks, dvs = [], [], []
    for s0 in range(0, q.shape[0], _PLAIN_BATCH_CHUNK):
        sl = slice(s0, s0 + _PLAIN_BATCH_CHUNK)
        qf, kf, vf, dof = qc[sl].float(), k[sl].float(), v[sl].float(), do[sl].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        p = rd(torch.exp2(rd(s - lse[sl][..., None])))
        dp = rd(torch.einsum("bqhd,bkhd->bhqk", dof, vf))
        ds = rd(p * rd(dp - delta[sl].permute(0, 2, 1)[..., None]))
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
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    _kernels.launch(
        "vst_dense_attn_bwd", q.device,
        int(q.dtype == torch.bfloat16), q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, sb, sn, sh, ob, on, oh,
        float(scale * LOG2E), float(scale),
    )
    dense_attention_bwd.launches += 1
    return dq, dk, dv


def dense_attention_bwd(q, k, v, o, lse, do, scale: float):
    """Gradients (dq, dk, dv) of dense attention from the forward's o and
    lse and the output cotangent do. CUDA tensors launch the Hopper
    kernel; CPU tensors take the plain version.
    `dense_attention_bwd.launches` counts kernel launches."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
    return _launch_bwd(q, k, v, o, lse, do, scale)


dense_attention_bwd.launches = 0


class _DenseAttention(torch.autograd.Function):
    """Forward K1, backward K2 (or their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, save):
        o, lse = _forward(q, k, v, scale)
        ctx.scale = scale
        if save:
            ctx.save_for_backward(q, k, v, o, lse)
        ctx.mark_non_differentiable(lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, _dlse):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = dense_attention_bwd(q, k, v, o, lse, do, ctx.scale)
        return dq, dk, dv, None, None


def dense_attention_fwd(q, k, v, scale: float):
    """Dense attention forward on [B, N, H, 64] q/k/v (float32 or bfloat16,
    N a multiple of 64, any B >= 1). Returns (o [B, N, H, 64], lse [B, H, N]
    f32); o is differentiable in q, k, v (backward: `dense_attention_bwd`),
    lse is not. CUDA tensors launch the Hopper kernel; CPU tensors take the
    plain version. `dense_attention_fwd.launches` counts kernel launches."""
    _check(q, k, v)
    save = torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v))
    return _DenseAttention.apply(q, k, v, scale, save)


dense_attention_fwd.launches = 0
