"""The Switch-style top-1 mixture-of-experts feed-forward evaluated on one
device (port of vae_song_tpu/parallel/ep.py:56-130: MoEParams, init_moe,
_capacity, _dispatch_combine, _expert_ffn, moe_ffn_dense). The expert-
parallel half of that module (moe_ffn_ep, the all_to_all exchange and the
sharded train steps) waits for ROADMAP.md Queue 1 item 15b.

Routing, as in JAX: router logits [T, E] = x @ router in x's dtype, the
softmax of those logits in that dtype (jax.nn.softmax's formula), the
top-1 expert by argmax (the first index on ties, as jnp.argmax), its
probability the gate; each expert takes at most C = ceil(T / E *
capacity_factor) tokens in arrival order, and the tokens past that are
dropped (their output is zero).

JAX builds the one-hot dispatch and combine tensors [T, E, C] and
contracts them with einsums. Each of those sums has one non-zero term, so
the port computes the same numbers by index and never materialises
[T, E, C] (43 GB in bf16 at the shipped config with 4 experts): the
tokens of each expert's queue are scattered into [E, C, D] (zeros in the
empty slots), the two expert products run as batched matmuls (JAX
computes them with plain einsums too), and each kept token takes
bf16(gate * its slot's output) back. The queue positions are counted
exactly in int64: JAX takes the cumulative sum of the one-hot in x's
dtype, which in bf16 stops counting exactly past 256 tokens an expert, so
there several tokens share a slot (ROADMAP.md Queue 3). The gate carries
the router's gradient; the argmax and the dropped tokens carry none.
"""

from typing import NamedTuple

import numpy as np
import torch

from vae_song_tpu_torch.nn.initializers import uniform_


class MoEParams(NamedTuple):
    """router [D, E]; the experts stacked [E, ...] (JAX's layout: the
    products are x @ w, not Linear-shaped)."""

    router: torch.Tensor    # [D, E]
    w1: torch.Tensor        # [E, D, H]
    b1: torch.Tensor        # [E, H]
    w2: torch.Tensor        # [E, H, D]
    b2: torch.Tensor        # [E, D]


def init_moe(d_model: int, hidden: int, n_experts: int, generator=None) -> MoEParams:
    """U(-1/sqrt(D), 1/sqrt(D)) router and first products, U(-1/sqrt(H),
    1/sqrt(H)) second products, zero biases (JAX `init_moe`), drawn from
    `generator` in the order router, w1, w2."""
    s1, s2 = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(hidden)
    router = uniform_(torch.empty(d_model, n_experts), s1, generator)
    w1 = uniform_(torch.empty(n_experts, d_model, hidden), s1, generator)
    w2 = uniform_(torch.empty(n_experts, hidden, d_model), s2, generator)
    return MoEParams(router, w1, torch.zeros(n_experts, hidden), w2,
                     torch.zeros(n_experts, d_model))


def _capacity(n_tokens: int, n_experts: int, capacity_factor: float) -> int:
    return int(np.ceil(n_tokens / n_experts * capacity_factor))


def _softmax(logits):
    """jax.nn.softmax over the last axis, op for op in the logits' dtype:
    exp(x - max), then that over its sum."""
    u = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return u / u.sum(dim=-1, keepdim=True)


def _dispatch_combine(x, router, n_experts: int, capacity: int):
    """Top-1 routing of tokens x [T, D]: (gate [T] in x's dtype, slot [T]
    int64: expert * capacity + the token's position in its expert's queue,
    keep [T] bool: the position is under the capacity)."""
    probs = _softmax(x @ router)                         # [T, E]
    expert = probs.argmax(dim=-1)                        # [T]
    gate = probs.gather(1, expert[:, None])[:, 0]        # [T]
    # each expert's running count over the tokens, scanned along the
    # contiguous axis of [E, T]: a scan down [T, E]'s 4 columns takes
    # CUDA's outer-dimension kernel, 22.0 ms a call at T = 131072 on an
    # H100 at 700 W, two thirds of the MoE SetVAE step
    # (scripts/ab_moe_step.py)
    counts = torch.nn.functional.one_hot(expert, n_experts).t().contiguous().cumsum(dim=1)
    pos = counts.gather(0, expert[None])[0] - 1
    return gate, expert * capacity + pos, pos < capacity


def _expert_ffn(w1, b1, w2, b2, h):
    """relu(h @ w1 + b1) @ w2 + b2 over the stacked experts, h [E, C, D]."""
    return torch.bmm(torch.relu(torch.bmm(h, w1) + b1[:, None, :]), w2) + b2[:, None, :]


def moe_ffn_dense(params: MoEParams, x, capacity_factor: float = 1.25):
    """Every expert on this device: x [T, D] -> [T, D] (JAX
    `moe_ffn_dense`), by index (the module's docstring)."""
    t, d = x.shape
    e = params.router.shape[1]
    c = _capacity(t, e, capacity_factor)
    gate, slot, keep = _dispatch_combine(x, params.router, e, c)
    # the dropped tokens go to one row past the slots, which is cut off:
    # a scatter whose gradient is a gather, so no sum lands on a shared row
    slot = torch.where(keep, slot, e * c)
    expert_in = x.new_zeros(e * c + 1, d).index_copy(0, slot, x)[:-1].view(e, c, d)
    out = _expert_ffn(params.w1, params.b1, params.w2, params.b2, expert_in)
    # the dropped tokens take that zero row back
    out = torch.cat([out.reshape(e * c, d), out.new_zeros(1, d)])
    return gate[:, None] * out.index_select(0, slot)
