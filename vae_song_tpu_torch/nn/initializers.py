"""Initializers matching the effective init of the reference
(vae_song_tpu/nn/initializers.py), drawn from an explicit
`torch.Generator` so a seed fixes the weights.

  * Linear weight and bias: torch's default kaiming_uniform_(a=sqrt(5)),
    i.e. U(-1/sqrt(fan_in), 1/sqrt(fan_in)).
  * MultiheadAttention in-projection: xavier_uniform_ on the stacked
    (3E, E) weight, i.e. U(-sqrt(1.5/fan_in), sqrt(1.5/fan_in)), bias 0
    (vae_song_tpu/ops/attention.py:25-30).
  * Learned query embeddings: N(0, 1) * 0.02
    (vae_song_tpu/models/setvae.py:356-360).
  * PositiveLinear's raw weight (the ICNN's, module.py:97-114):
    kaiming_uniform_(a=sqrt(5)), the Linear bound 1/sqrt(fan_in)
    (vae_song_tpu/nn/initializers.py:torch_positive_linear_init).
"""

import math

import torch


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, generator=None) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=generator)


def torch_linear_bound(fan_in: int) -> float:
    """kaiming_uniform(a=sqrt(5)) == uniform with bound 1/sqrt(fan_in)."""
    return 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0


def torch_positive_linear_bound(fan_in: int) -> float:
    """PositiveLinear's weight bound: kaiming_uniform(a=sqrt(5)) on the raw
    weight, whose bound depends only on fan_in."""
    return torch_linear_bound(fan_in)


def mha_in_proj_bound(fan_in: int) -> float:
    """xavier_uniform on the stacked (3E, E) in-projection weight."""
    return math.sqrt(1.5 / fan_in)


@torch.no_grad()
def normal_scaled_(t: torch.Tensor, std: float = 0.02, generator=None) -> torch.Tensor:
    return t.normal_(0.0, 1.0, generator=generator).mul_(std)
