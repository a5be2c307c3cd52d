"""Dense and LayerNorm with the Flax compute-dtype semantics of
vae_song_tpu/nn/blocks.py (port). Parameters stay float32; `dtype` is
the compute dtype.

  * Dense(dtype=bf16): input, weight and bias cast to bf16, the product
    rounded to bf16, then the bias added in bf16 (flax.linen.Dense).
  * Dense(dtype=None): the input is promoted with the f32 parameters, so
    a bf16 input gives an f32 result.
  * LayerNorm(dtype=bf16): statistics and normalisation in f32, output
    rounded to bf16; eps 1e-5.
"""

import torch
import torch.nn.functional as F
from torch import nn

from vae_song_tpu_torch.nn import initializers as init


class Dense(nn.Module):
    """nn.Linear-shaped layer (weight [out, in]) with a compute dtype.

    `weight_bound` / `bias_bound` are the U(-bound, bound) init bounds;
    they default to torch's Linear init (1/sqrt(fan_in)). A bias bound of
    0 starts the bias at zero."""

    def __init__(self, in_features: int, out_features: int, dtype=None,
                 weight_bound=None, bias_bound=None, generator=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features))
        default = init.torch_linear_bound(in_features)
        init.uniform_(self.weight, default if weight_bound is None else weight_bound, generator)
        init.uniform_(self.bias, default if bias_bound is None else bias_bound, generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        # product and bias add round separately, as the Flax layer does
        return torch.matmul(x.to(dt), self.weight.to(dt).t()) + self.bias.to(dt)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm(epsilon=1e-5, dtype=dtype) over the last axis."""

    eps = 1e-5

    def __init__(self, features: int, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        y = F.layer_norm(x.float(), self.weight.shape, self.weight, self.bias, self.eps)
        return y.to(self.dtype or torch.promote_types(x.dtype, torch.float32))
