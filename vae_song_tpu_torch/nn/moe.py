"""The mixture-of-experts feed-forward of the set transformers (port of
vae_song_tpu/nn/moe.py:MoEFFN on one device): SetVAE / SetLRVAE with
`moe_experts: E` swap each transformer layer's dense two-layer FFN for a
top-1-routed MoE over the flattened tokens (parallel/ep.py:moe_ffn_dense).

Parameters, in the JAX layout (weights.py carries them across as they
are): router [D, E], w1 [E, D, H], b1 [E, H], w2 [E, H, D], b2 [E, D].
They stay float32; under `compute_dtype` the tokens and every parameter
are cast to it, as the JAX module casts them. The capacity C =
ceil(B * N / E * capacity_factor) counts every token of the call.

Inside nn.sync.expert_sharded (the JAX module's `ep_axis`, :51-75) the
same parameters run expert-parallel: the expert stacks are DTensors split
one expert a rank (parallel/ep.py:shard_setvae_ep_state), and the call
takes `moe_ffn_ep` on this rank's tokens and expert slice.
"""

import torch
from torch import nn

from vae_song_tpu_torch.nn.sync import expert_group, local_tensor
from vae_song_tpu_torch.parallel.ep import MoEParams, init_moe, moe_ffn_dense, moe_ffn_ep


class MoEFFN(nn.Module):
    """x [B, N, D] -> [B, N, D]."""

    def __init__(self, d_model: int, ff_dim: int, n_experts: int,
                 capacity_factor: float = 1.25, compute_dtype=None, generator=None):
        super().__init__()
        self.capacity_factor = capacity_factor
        self.dtype = compute_dtype
        init = init_moe(d_model, ff_dim, n_experts, generator)
        for name, value in init._asdict().items():
            setattr(self, name, nn.Parameter(value))

    def params(self) -> MoEParams:
        """The parameters (this rank's slices of split ones), cast to the
        compute dtype."""
        ps = (local_tensor(getattr(self, f)) for f in MoEParams._fields)
        return MoEParams(*(p if self.dtype is None else p.to(self.dtype) for p in ps))

    def forward(self, x):
        if self.dtype is not None:
            x = x.to(self.dtype)
        b, n, d = x.shape
        group = expert_group()
        if group is not None:
            out = moe_ffn_ep(self.params(), x.reshape(b * n, d), group, self.capacity_factor)
        else:
            out = moe_ffn_dense(self.params(), x.reshape(b * n, d), self.capacity_factor)
        return out.view(b, n, d)
