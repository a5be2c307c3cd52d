"""Dense, LayerNorm, BatchNorm and dropout with the Flax semantics of
vae_song_tpu/nn/blocks.py (port). Parameters stay float32; `dtype` is
the compute dtype.

  * Dense(dtype=bf16): input, weight and bias cast to bf16, the product
    rounded to bf16, then the bias added in bf16 (flax.linen.Dense).
  * Dense(dtype=None): the input is promoted with the f32 parameters, so
    a bf16 input gives an f32 result.
  * LayerNorm(dtype=bf16): statistics and normalisation in f32, output
    rounded to bf16; eps 1e-5.
  * BatchNorm: flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5), the
    running statistics kept in buffers.
  * dropout: flax.linen.Dropout in training, its keep mask drawn from an
    explicit source.
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


class BatchNorm(nn.Module):
    """flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5) as the JAX
    package's `BatchNorm` uses it, over every axis but the last.

    Training mode normalises with the batch's f32 statistics, the
    variance as E[x^2] - E[x]^2 (clamped at 0; Flax's use_fast_variance),
    and moves the running buffers to 0.9 * running + 0.1 * batch with the
    BIASED batch variance (torch's own running update stores the unbiased
    one). Eval mode normalises with the running statistics. The buffers
    are the JAX package's `batch_stats` {mean, var}."""

    eps = 1e-5
    momentum = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        x = x.float()
        if self.training:
            axes = tuple(range(x.dim() - 1))
            mean = x.mean(axes)
            var = torch.clamp((x * x).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                for buf, stat in ((self.running_mean, mean), (self.running_var, var)):
                    buf.copy_(self.momentum * buf + (1 - self.momentum) * stat)
        else:
            mean, var = self.running_mean, self.running_var
        # Flax's _normalize: (x - mean) * (rsqrt(var + eps) * scale) + bias
        return (x - mean) * (torch.rsqrt(var + self.eps) * self.weight) + self.bias


def keep_mask(source, shape, keep_prob: float, device) -> torch.Tensor:
    """A boolean keep mask of `shape` on `device`: from a torch.Generator
    on `device`'s type, uniform < keep_prob (jax.random.bernoulli's
    rule); or from a callable source(shape, keep_prob) that hands out
    masks (the tests feed both packages the same ones). A generator on
    another device type raises: a mask drawn on the host for a model on
    the card would be copied over at every call."""
    if isinstance(source, torch.Generator):
        if source.device.type != torch.device(device).type:
            raise ValueError(
                f"dropout: a {source.device.type} torch.Generator for tensors on "
                f"{torch.device(device).type}; give a generator on the tensors' device"
            )
        u = torch.rand(shape, generator=source, device=device)
        return u < keep_prob
    return source(tuple(shape), keep_prob).to(device)


def dropout(x, rate: float, source):
    """flax.linen.Dropout(rate) in training: where(mask, x / keep_prob, 0)
    in x's dtype (keep_prob rounded to that dtype first, as JAX rounds
    the Python scalar), zeros at rate 1, x itself at rate 0. `source`
    gives the keep mask (`keep_mask`); a call with rate > 0 and no
    source raises."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return torch.zeros_like(x)
    if source is None:
        raise ValueError("dropout in training needs a mask source (a torch.Generator)")
    keep = 1.0 - rate
    mask = keep_mask(source, x.shape, keep, x.device)
    # keep_prob rounded to x's dtype on the host: a Python scalar, so no
    # copy to the device
    keep_x = torch.tensor(keep, dtype=x.dtype).item()
    return torch.where(mask, x / keep_x, 0.0)


class Dropout(nn.Module):
    """`dropout` in training mode, the identity in eval mode."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x, source=None):
        return dropout(x, self.rate, source) if self.training else x
