"""torch-style multi-head attention (port of
vae_song_tpu/ops/attention.py:MultiHeadAttention, :311) and the
sequence-parallel attention (:175 sequence_sharded_attention, :192
ring_attention).

Separate query/key/value/out projections with torch
nn.MultiheadAttention's init, scale 1/sqrt(head_dim). Path selection:

  S. a self-attention module (`self_attention=True`, the layers' own)
     inside nn.sync.sequence_sharded (the JAX package's `seq_axis`,
     :390-407): the point axis is sharded over the context's group, so
     the keys and values come from every rank, by all-gather
     (`sequence_sharded_attention`) or round the ring (`ring_attention`).
     Training dropout is refused there; no kernel runs (JAX :424 takes
     its kernels only without `seq_axis`), and the kv-length-1 shortcut
     below is off, as one point a shard must still reach the others.
     The route follows the context and never the shape: on one rank the
     shard is the whole cloud, which route 2 would otherwise take.

  0. training with dropout_rate > 0 (JAX :407-423): materialised
     scores, as torch's MultiheadAttention drops attention WEIGHTS:
     logits = bf16(q) bf16(k)^T in f32 times the scale, an f32 softmax,
     dropout on the weights, then bf16(weights) bf16(v) in f32, cast to
     q's dtype. No kernel: the JAX package computes this branch in XLA.
     At kv length 1 training falls through to this branch too (JAX
     :328-329), where the dropout zeroes whole rows.
  1. kv length 1 (the set decoder's cross-attention to its latent
     token): softmax over one key is identically 1, so the output is the
     value projection broadcast over the queries. Only the value and out
     projections run; the query/key parameters exist but are unused, so
     they get no gradient and the optimizer leaves them as they are (the
     JAX package gives them zero gradients, which optax's Adam turns into
     zero updates).
  2. shapes the JAX package sends to its packed kernel (`packed_ok`):
     dense attention's packed route (ops/denseattn.py), differentiable
     through its autograd Function: the K1 forward and K2 backward
     kernels on CUDA tensors.
  3. the other shapes the JAX package sends to its dense kernel
     (`dense_ok`: heads not 64 wide, or an odd head count, any width
     D % 64 == 0): dense attention's BHND route, the K3f forward and K3b
     backward kernels on CUDA tensors.
  4. everything else: plain attention with bf16 matmuls and an f32
     softmax, as the JAX package's `_xla_attention`, differentiated by
     autograd.

The head count is read from the projections' width: under tensor
parallelism (parallel/tp.py) they give this rank's heads, on which the
route is chosen, as the JAX dense kernels partition over heads (with two
local heads of 64 the packed route, with one the BHND route).
VST_FUSED_QKV=1 is refused under tensor parallelism.

The route follows the JAX package's order (vae_song_tpu/ops/attention.py
:424-448) and never the device: on a CPU tensor routes 2 and 3 run their
kernels' plain versions. The JAX package's three switches are read at
call time, with its spellings and defaults:

  * VST_DISABLE_DENSE_ATTN=1 (any value but "", "0" or "false") turns
    routes 2 and 3 off: every shape takes route 4;
  * VST_DENSE_ATTN_PACKED=0 (or "false") turns route 2 off: its shapes
    take route 3;
  * VST_FUSED_QKV=1 (or "true") runs self-attention's in-projection (the
    query input and the key/value input one tensor) as one [d, 3d]
    product over the query, key and value weights concatenated at call
    time; the parameters stay three projections.
"""

import math
import os

import torch
from torch import nn

from vae_song_tpu_torch.nn import collectives
from vae_song_tpu_torch.nn.blocks import Dense, Dropout
from vae_song_tpu_torch.nn.sync import is_dtensor, seq_shard
from vae_song_tpu_torch.nn.initializers import mha_in_proj_bound
from vae_song_tpu_torch.ops.denseattn import (dense_attention, dense_attention_fwd, dense_ok,
                                              packed_ok)


def attention_plain(q, k, v, scale: float, drop=None):
    """q, k, v: [B, N, H, D]; matmuls on bf16-rounded inputs with f32
    accumulation, softmax in f32, output in q's dtype (_xla_attention
    with its default bf16 compute dtype, which the JAX package uses for
    f32 models too). `drop`, if given, is applied to the f32 weights
    [B, H, Nq, Nk] (the training-dropout branch)."""
    qc, kc, vc = (a.to(torch.bfloat16).float() for a in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc).mul_(scale)
    weights = torch.softmax(logits, dim=-1)
    if drop is not None:
        weights = drop(weights)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(torch.bfloat16).float(), vc)
    return out.to(q.dtype)


def sequence_sharded_attention(q, k, v, scale: float, group):
    """Self-attention over a point axis sharded over `group` (JAX
    :175, the all-gather variant): this rank's queries [B, N/p, H, D]
    against the keys and values gathered from every rank [B, N, H, D],
    by `attention_plain` (bf16 q, k, v and weights, f32 scores and
    softmax). The gather's backward sums the key and value cotangents of
    every rank into their owner's slice."""
    k_full = collectives.all_gather(k, group, dim=1)
    v_full = collectives.all_gather(v, group, dim=1)
    return attention_plain(q, k_full, v_full, scale)


def _bf16(t):
    return t.to(torch.bfloat16).float()


def _ring_fold(qc, m, l, acc, k, v, scale):
    """One key/value chunk folded into the online softmax (JAX :220-233):
    f32 scores of bf16 operands, the running row max, natural exp, the
    accumulator rescaled by exp(m_old - m_new)."""
    s = torch.einsum("bqhd,bkhd->bhqk", qc, _bf16(k)).mul_(scale)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)                       # exp(-inf) = 0 at the first chunk
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", _bf16(p), _bf16(v))
    return m_new, l_new, acc * alpha.transpose(1, 2)[..., None] + pv


class _RingAttention(torch.autograd.Function):
    """The ring: k/v chunks rotate one rank on a hop and fold into the
    online softmax; the last chunk folds without a rotation after it
    (JAX :250-256). Saves this rank's q, k, v, the output and the row
    log-sum-exp; the backward runs the ring again, recomputing each
    hop's [N/p, N/p] block, while the chunks' key and value gradients
    travel with them and arrive at their owner after the last hop. The
    [N/p, N] scores never exist."""

    @staticmethod
    def forward(ctx, q, k, v, scale, group):
        n = torch.distributed.get_world_size(group)
        b, nq, h, _ = q.shape
        qc = _bf16(q)
        m = q.new_full((b, h, nq), -math.inf, dtype=torch.float32)
        l = torch.zeros_like(m)
        acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        kc, vc = k, v
        for _ in range(n - 1):
            m, l, acc = _ring_fold(qc, m, l, acc, kc, vc, scale)
            kc, vc = collectives.rotate([kc, vc], group)
        m, l, acc = _ring_fold(qc, m, l, acc, kc, vc, scale)
        out = acc / l.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.scale, ctx.group, ctx.n = scale, group, n
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        scale, n = ctx.scale, ctx.n
        qc, do = _bf16(q), do.float()
        delta = (do * out).sum(dim=-1).transpose(1, 2)   # [B, H, Nq]
        dq = torch.zeros_like(out)
        kc, vc = k, v
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        for hop in range(n):
            kb, vb = _bf16(kc), _bf16(vc)
            s = torch.einsum("bqhd,bkhd->bhqk", qc, kb).mul_(scale)
            p = torch.exp(s - lse[..., None])
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", _bf16(p), do)
            ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, vb) - delta[..., None])
            dq += torch.einsum("bhqk,bkhd->bqhd", ds, kb) * scale
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, qc) * scale
            if hop < n - 1:
                kc, vc, dk, dv = collectives.rotate([kc, vc, dk, dv], ctx.group)
            elif n > 1:
                # the chunks' gradients take the last hop home
                dk, dv = collectives.rotate([dk, dv], ctx.group)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def ring_attention(q, k, v, scale: float, group):
    """Self-attention over a point axis sharded over `group`, the ring
    variant (JAX :192): exact up to the order of the f32 sums, with
    O(N/p) key/value memory a rank. Output in q's dtype."""
    return _RingAttention.apply(q, k, v, scale, group)


def _dense_attn_on() -> bool:
    """Routes 2 and 3 allowed: VST_DISABLE_DENSE_ATTN unset, "", "0" or
    "false" (the JAX package's `_dense_default_ok` opt-out)."""
    return os.environ.get("VST_DISABLE_DENSE_ATTN", "").lower() in ("", "0", "false")


def _packed_attn_on() -> bool:
    """Route 2 allowed: VST_DENSE_ATTN_PACKED not "0" or "false" (the JAX
    package's `_packed_attn_ok` switch, default on)."""
    return os.environ.get("VST_DENSE_ATTN_PACKED", "1").lower() not in ("0", "false")


def _fused_qkv_on() -> bool:
    """The opt-in VST_FUSED_QKV=1 (or "true") of the JAX package's
    `_fused_qkv_on`, off by default."""
    return os.environ.get("VST_FUSED_QKV", "0").lower() in ("1", "true")


class MultiHeadAttention(nn.Module):

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0,
                 compute_dtype=None, generator=None, self_attention: bool = False):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        # a layer's self-attention: the module sequence parallelism shards
        self.self_attention = self_attention
        bound = mha_in_proj_bound(d_model)

        def in_proj():
            return Dense(d_model, d_model, dtype=compute_dtype, weight_bound=bound,
                         bias_bound=0.0, generator=generator)

        self.query = in_proj()
        self.key = in_proj()
        self.value = in_proj()
        self.out = Dense(d_model, d_model, dtype=compute_dtype, bias_bound=0.0,
                         generator=generator)
        self.drop = Dropout(dropout_rate)

    def forward(self, inputs_q, inputs_kv, dropout_rng=None):
        """`dropout_rng` is the keep-mask source of training dropout
        (nn.blocks.keep_mask); unused in eval mode or at rate 0. The head
        count is the projections' width over the head width: under tensor
        parallelism (parallel/tp.py) the projections give this rank's
        heads only, and the route is chosen for them."""
        d = self.d_model // self.num_heads
        b, n_q = inputs_q.shape[0], inputs_q.shape[1]
        n_kv = inputs_kv.shape[1]
        train_dropout = self.dropout_rate > 0.0 and self.training
        sp = seq_shard() if self.self_attention else None
        if n_kv == 1 and sp is None and not train_dropout:
            # softmax over one key is 1: out-project the value once per
            # cloud and broadcast it over the queries
            return self.out(self.value(inputs_kv)).expand(b, n_q, self.d_model)
        if inputs_q is inputs_kv and _fused_qkv_on():
            # one [d, 3d] product over the three projections' parameters,
            # with Dense's compute-dtype semantics; q, k, v are views of it
            projs = (self.query, self.key, self.value)
            if is_dtensor(self.query.weight):
                raise ValueError("VST_FUSED_QKV=1 is refused under tensor parallelism "
                                 "(parallel/tp.py:check_flash_partitionable)")
            h = self.num_heads
            w3 = torch.cat([p.weight for p in projs])
            b3 = torch.cat([p.bias for p in projs])
            dt = self.query.dtype or torch.promote_types(inputs_q.dtype, w3.dtype)
            qkv = torch.matmul(inputs_q.to(dt), w3.to(dt).t()) + b3.to(dt)
            q, k, v = (t.view(b, n_q, h, d) for t in qkv.split(self.d_model, dim=-1))
        else:
            q = self.query(inputs_q)
            h = q.shape[-1] // d
            q = q.view(b, n_q, h, d)
            k = self.key(inputs_kv).view(b, n_kv, h, d)
            v = self.value(inputs_kv).view(b, n_kv, h, d)
        scale = 1.0 / math.sqrt(d)
        dense_on = _dense_attn_on()
        if sp is not None:
            if train_dropout:
                raise NotImplementedError(
                    "attention-weight dropout is not supported under "
                    "sequence parallelism (seq_axis)"
                )
            sp_attn = ring_attention if sp.ring else sequence_sharded_attention
            out = sp_attn(q, k, v, scale, sp.group)
        elif train_dropout:
            out = attention_plain(q, k, v, scale, lambda w: self.drop(w, dropout_rng))
        elif dense_on and _packed_attn_on() and packed_ok(n_q, n_kv, h, d):
            out, _ = dense_attention_fwd(q, k, v, scale)
        elif dense_on and dense_ok(n_q, n_kv, d):
            out = dense_attention(q, k, v, scale)
        else:
            out = attention_plain(q, k, v, scale)
        return self.out(out.reshape(b, n_q, h * d))
