"""torch-style multi-head attention (port of
vae_song_tpu/ops/attention.py:MultiHeadAttention, the JAX :311 path
without sequence parallelism).

Separate query/key/value/out projections with torch
nn.MultiheadAttention's init, scale 1/sqrt(head_dim). Path selection:

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
     (`dense_ok`: heads not 64 wide, or an odd head count): dense
     attention's BHND route, the K3f forward and K3b backward kernels on
     CUDA tensors. A head width above 256 raises (the kernels are built
     up to 256).
  4. everything else: plain attention with bf16 matmuls and an f32
     softmax, as the JAX package's `_xla_attention`, differentiated by
     autograd.

The route follows the JAX package's order (vae_song_tpu/ops/attention.py
:424-448) and never the device: on a CPU tensor routes 2 and 3 run their
kernels' plain versions.
"""

import math

import torch
from torch import nn

from vae_song_tpu_torch.nn.blocks import Dense
from vae_song_tpu_torch.nn.initializers import mha_in_proj_bound
from vae_song_tpu_torch.ops.denseattn import (dense_attention, dense_attention_fwd, dense_ok,
                                              packed_ok)


def attention_plain(q, k, v, scale: float):
    """q, k, v: [B, N, H, D]; matmuls on bf16-rounded inputs with f32
    accumulation, softmax in f32, output in q's dtype (_xla_attention
    with its default bf16 compute dtype, which the JAX package uses for
    f32 models too)."""
    qc, kc, vc = (a.to(torch.bfloat16).float() for a in (q, k, v))
    logits = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
    weights = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", weights.to(torch.bfloat16).float(), vc)
    return out.to(q.dtype)


class MultiHeadAttention(nn.Module):

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.0,
                 compute_dtype=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        bound = mha_in_proj_bound(d_model)

        def in_proj():
            return Dense(d_model, d_model, dtype=compute_dtype, weight_bound=bound,
                         bias_bound=0.0, generator=generator)

        self.query = in_proj()
        self.key = in_proj()
        self.value = in_proj()
        self.out = Dense(d_model, d_model, dtype=compute_dtype, bias_bound=0.0,
                         generator=generator)

    def forward(self, inputs_q, inputs_kv):
        if self.dropout_rate > 0.0 and self.training:
            raise NotImplementedError(
                "attention-weight dropout in training is not ported yet "
                "(the shipped configs set attn_dropout: 0.0)"
            )
        h = self.num_heads
        d = self.d_model // h
        b, n_q = inputs_q.shape[0], inputs_q.shape[1]
        n_kv = inputs_kv.shape[1]
        if n_kv == 1:
            # softmax over one key is 1: out-project the value once per
            # cloud and broadcast it over the queries
            return self.out(self.value(inputs_kv)).expand(b, n_q, self.d_model)
        q = self.query(inputs_q).view(b, n_q, h, d)
        k = self.key(inputs_kv).view(b, n_kv, h, d)
        v = self.value(inputs_kv).view(b, n_kv, h, d)
        scale = 1.0 / math.sqrt(d)
        if packed_ok(n_q, n_kv, h, d):
            out, _ = dense_attention_fwd(q, k, v, scale)
        elif dense_ok(n_q, n_kv, d):
            out = dense_attention(q, k, v, scale)
        else:
            out = attention_plain(q, k, v, scale)
        return self.out(out.reshape(b, n_q, self.d_model))
