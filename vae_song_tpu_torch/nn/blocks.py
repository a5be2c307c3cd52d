"""The building blocks of vae_song_tpu/nn/blocks.py with their Flax
semantics (port): Dense, LayerNorm, BatchNorm, dropout, and the MLP and
convolution blocks of the FlexibleVAE family. Parameters stay float32;
`dtype` is the compute dtype.

  * Dense(dtype=bf16): input, weight and bias cast to bf16, the product
    rounded to bf16, then the bias added in bf16 (flax.linen.Dense).
  * Dense(dtype=None): the input is promoted with the f32 parameters, so
    a bf16 input gives an f32 result.
  * Conv / ConvTranspose: the same casts and roundings as Dense (the
    convolution, then the bias add); images are NHWC at the API, as in
    the JAX package, and each convolution reads and writes them through
    a channels-last view, so no layout copy is made. f32 convolutions
    run with cuDNN's TF32 off, forward and backward, whatever the
    caller's `torch.backends.cudnn.allow_tf32` says.
  * LayerNorm(dtype=bf16): statistics and normalisation in f32, output
    rounded to bf16; eps 1e-5.
  * BatchNorm: flax.linen.BatchNorm(momentum=0.9, epsilon=1e-5), the
    running statistics kept in buffers; its output is at least f32.
  * dropout: flax.linen.Dropout in training, its keep mask drawn from an
    explicit source.
  * MLPBlock, ResidualMLPBlock, ResidualConvBlock, PlainConvolution:
    Dense / Conv -> BatchNorm -> LeakyReLU(0.01) stacks.
  * PositiveLinear, ICNN, LinearModuleEP: LID-VAE's input-convex network
    (module.py:97-182): `dense` holds the Flax Dense_i children in order,
    `positive` the PositiveLinear_i.
"""

import contextlib
import re

import torch
import torch.nn.functional as F
from torch import nn

from vae_song_tpu_torch.nn import initializers as init
from vae_song_tpu_torch.nn import sync


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
    are the JAX package's `batch_stats` {mean, var}. Under
    nn.sync.global_batch the statistics are the global batch's."""

    eps = 1e-5
    momentum = 0.9

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        # at least f32, as Flax promotes (float64 stays float64)
        x = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            axes = tuple(range(x.dim() - 1))
            # the global batch's statistics under nn.sync.global_batch
            mean = sync.mean_over_batch(x.mean(axes))
            var = torch.clamp(sync.mean_over_batch((x * x).mean(axes)) - mean * mean, min=0.0)
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


LRELU_SLOPE = 0.01  # torch nn.LeakyReLU's default, as the JAX package's lrelu


def lrelu(x, slope: float = LRELU_SLOPE):
    return F.leaky_relu(x, slope)


@contextlib.contextmanager
def _ieee_f32(x):
    """cuDNN's TF32 off while an f32 convolution on the card runs (PyTorch
    leaves `torch.backends.cudnn.allow_tf32` on by default); nothing
    otherwise."""
    if x.dtype != torch.float32 or x.device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


@contextlib.contextmanager
def _deterministic(x):
    """cuDNN's deterministic algorithms while a convolution on the card
    runs; nothing otherwise. cuDNN's default choice for some convolution
    backwards is not deterministic (H100: two runs of six steps of the
    conv VAE of bench.py:72 from the same weights and inputs end 8e-2
    apart); with these a resumed run repeats the continuous one bit for
    bit."""
    if x.device.type != "cuda":
        yield
        return
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        yield
    finally:
        torch.backends.cudnn.deterministic = prev


class _Conv2d(torch.autograd.Function):
    """conv2d (or conv_transpose2d) of NCHW x by w, no bias, dilation 1,
    one group; forward and backward under `_ieee_f32` and `_deterministic`,
    since autograd runs the backward after the forward's context has
    closed."""

    @staticmethod
    def forward(ctx, x, w, stride, padding, transposed):
        ctx.save_for_backward(x, w)
        ctx.conf = stride, padding, transposed
        conv = F.conv_transpose2d if transposed else F.conv2d
        with _ieee_f32(x), _deterministic(x):
            return conv(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, gy):
        x, w = ctx.saved_tensors
        stride, padding, transposed = ctx.conf
        with _ieee_f32(x), _deterministic(x):
            gx, gw, _ = torch.ops.aten.convolution_backward(
                gy, x, w, None, [stride] * 2, [padding] * 2, [1, 1], transposed, [0, 0], 1,
                [ctx.needs_input_grad[0], ctx.needs_input_grad[1], False])
        return gx, gw, None, None, None


def _conv_nhwc(x, w, stride, padding, transposed=False):
    """`_Conv2d` on NHWC x through its channels-last NCHW view; NHWC out."""
    return _Conv2d.apply(x.permute(0, 3, 1, 2), w, stride, padding, transposed).permute(
        0, 2, 3, 1)


class Conv(nn.Module):
    """flax.linen.Conv as the JAX package's `Conv` uses it (k x k, stride,
    symmetric zero padding) on NHWC images, with torch's Conv2d layout
    (weight [out, in, k, k]) and default init; the bounds can be set as
    for Dense."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int = 3,
                 stride: int = 1, padding: int = 1, dtype=None, weight_bound=None,
                 bias_bound=None, generator=None):
        super().__init__()
        self.dtype, self.stride, self.padding = dtype, stride, padding
        self.weight = nn.Parameter(
            torch.empty(out_features, in_features, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.empty(out_features))
        default = init.torch_linear_bound(in_features * kernel_size * kernel_size)
        init.uniform_(self.weight, default if weight_bound is None else weight_bound, generator)
        init.uniform_(self.bias, default if bias_bound is None else bias_bound, generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        y = _conv_nhwc(x.to(dt), self.weight.to(dt), self.stride, self.padding)
        return y + self.bias.to(dt)


class ConvTranspose(nn.Module):
    """The JAX package's UpConv on NHWC images: flax.linen.ConvTranspose(3,
    strides 2, padding "SAME") cropped to 2n - 1 + output_padding rows and
    columns. Flax's "SAME" transposed convolution of an n-wide input is
    torch's conv_transpose2d(stride 2, padding 0) cut to its first 2n, so
    this is that cut to its first 2n - 1 + output_padding. Not torch's
    ConvTranspose2d(padding=1, output_padding=p), which is the same image
    shifted by one pixel. The weight is torch's ConvTranspose2d layout
    [in, out, 3, 3], the Flax kernel flipped in both spatial axes
    (weights.py). Init: U(+-1/sqrt(9 * out)) for weight and bias, the fan
    of torch's ConvTranspose2d."""

    def __init__(self, in_features: int, out_features: int, output_padding: int, dtype=None,
                 generator=None):
        super().__init__()
        self.dtype, self.output_padding = dtype, output_padding
        self.weight = nn.Parameter(torch.empty(in_features, out_features, 3, 3))
        self.bias = nn.Parameter(torch.empty(out_features))
        bound = init.torch_linear_bound(9 * out_features)
        init.uniform_(self.weight, bound, generator)
        init.uniform_(self.bias, bound, generator)

    def forward(self, x):
        dt = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        h = 2 * x.shape[1] - 1 + self.output_padding
        w = 2 * x.shape[2] - 1 + self.output_padding
        y = _conv_nhwc(x.to(dt), self.weight.to(dt), 2, 0, transposed=True)
        return y[:, :h, :w] + self.bias.to(dt)


class MLPBlock(nn.Module):
    """Dense -> BatchNorm -> LeakyReLU."""

    def __init__(self, in_features: int, out_features: int, dtype=None, generator=None):
        super().__init__()
        self.dense = Dense(in_features, out_features, dtype=dtype, generator=generator)
        self.norm = BatchNorm(out_features)

    def forward(self, x):
        return lrelu(self.norm(self.dense(x)))


class ResidualMLPBlock(nn.Module):
    """Dense-BN-LReLU -> Dense-BN, plus the input (through Dense-BN when
    the widths differ), then LReLU. `dense` and `norm` hold the layers in
    the JAX block's order: main path, then the projection."""

    def __init__(self, in_features: int, out_features: int, dtype=None, generator=None):
        super().__init__()
        dims = [(in_features, out_features), (out_features, out_features)]
        if in_features != out_features:
            dims.append((in_features, out_features))
        self.dense = nn.ModuleList(Dense(i, o, dtype=dtype, generator=generator) for i, o in dims)
        self.norm = nn.ModuleList(BatchNorm(out_features) for _ in dims)

    def forward(self, x):
        out = lrelu(self.norm[0](self.dense[0](x)))
        out = self.norm[1](self.dense[1](out))
        identity = x if len(self.dense) == 2 else self.norm[2](self.dense[2](x))
        return lrelu(out + identity)


class ResidualConvBlock(nn.Module):
    """Conv3x3(stride)-BN-LReLU -> Conv3x3-BN, plus the input (through a
    1x1 Conv(stride)-BN when the stride or the width changes), then
    LReLU. NHWC. `conv` and `norm` hold the layers in the JAX block's
    order."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1, dtype=None,
                 generator=None):
        super().__init__()
        convs = [Conv(in_features, out_features, 3, stride, 1, dtype, generator=generator),
                 Conv(out_features, out_features, 3, 1, 1, dtype, generator=generator)]
        if stride != 1 or in_features != out_features:
            convs.append(Conv(in_features, out_features, 1, stride, 0, dtype,
                              generator=generator))
        self.conv = nn.ModuleList(convs)
        self.norm = nn.ModuleList(BatchNorm(out_features) for _ in convs)

    def forward(self, x):
        out = lrelu(self.norm[0](self.conv[0](x)))
        out = self.norm[1](self.conv[1](out))
        identity = x if len(self.conv) == 2 else self.norm[2](self.conv[2](x))
        return lrelu(out + identity)


class PlainConvolution(nn.Module):
    """2 x (Conv3x3 -> BatchNorm -> LeakyReLU), no skip. NHWC."""

    def __init__(self, in_features: int, out_features: int, stride: int = 1, dtype=None,
                 generator=None):
        super().__init__()
        self.conv = nn.ModuleList([
            Conv(in_features, out_features, 3, stride, 1, dtype, generator=generator),
            Conv(out_features, out_features, 3, 1, 1, dtype, generator=generator)])
        self.norm = nn.ModuleList(BatchNorm(out_features) for _ in range(2))

    def forward(self, x):
        for conv, norm in zip(self.conv, self.norm):
            x = lrelu(norm(conv(x)))
        return x


class PositiveLinear(nn.Module):
    """x @ exp(W)^T, or x @ clamp(W, min=1e-2)^T with `is_exp=False`; no
    bias. `weight` is the raw W, Linear-shaped [out, in] (the Flax kernel
    [in, out] transposed, weights.py)."""

    def __init__(self, in_features: int, out_features: int, is_exp: bool = True,
                 generator=None):
        super().__init__()
        self.is_exp = is_exp
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        init.uniform_(self.weight, init.torch_positive_linear_bound(in_features), generator)

    def forward(self, x):
        w = torch.exp(self.weight) if self.is_exp else torch.clamp(self.weight, min=1e-2)
        return torch.matmul(x, w.t())


ICNN_SLOPE = 0.2  # the ICNN's LeakyReLU (module.py:117-148)


def _icnn_act(x):
    return F.leaky_relu(x, ICNN_SLOPE)


class ICNN(nn.Module):
    """Input-convex network with a scalar output: z0 = lrelu_0.2(A_0 x)^2,
    z_{k+1} = lrelu_0.2(W_k+ z_k + A_{k+1} x), the last to width 1. Convex
    in x: the W_k+ are positive and the activation is convex and
    nondecreasing. `dense[k]` is A_k (Flax Dense_k), `positive[k]` W_k+
    (PositiveLinear_k)."""

    def __init__(self, in_features: int, hidden_channel: int = 128, num_layers: int = 2,
                 generator=None):
        super().__init__()
        outs = [hidden_channel] * num_layers + [1]
        self.dense = nn.ModuleList(Dense(in_features, o, generator=generator) for o in outs)
        self.positive = nn.ModuleList(PositiveLinear(hidden_channel, o, generator=generator)
                                      for o in outs[1:])

    def forward(self, x):
        z = _icnn_act(self.dense[0](x)) ** 2
        for pos, dense in zip(self.positive, self.dense[1:]):
            z = _icnn_act(pos(z) + dense(x))
        return z


class LinearModuleEP(nn.Module):
    """The ICNN's non-convex ablation twin (module.py:151-182): plain Dense
    layers in place of PositiveLinear, the last hidden -> in_features plus
    a Dense(1) of x. `dense` holds the Flax Dense_i children in the order
    Flax names them: A_0, then per layer the z and x products, then the
    last z and x products."""

    def __init__(self, in_features: int, hidden_channel: int = 128, num_layers: int = 2,
                 generator=None):
        super().__init__()
        dims = [(in_features, hidden_channel)]
        for _ in range(num_layers - 1):
            dims += [(hidden_channel, hidden_channel), (in_features, hidden_channel)]
        dims += [(hidden_channel, in_features), (in_features, 1)]
        self.dense = nn.ModuleList(Dense(i, o, generator=generator) for i, o in dims)

    def forward(self, x):
        z = _icnn_act(self.dense[0](x)) ** 2
        for k in range(1, len(self.dense), 2):
            z = _icnn_act(self.dense[k](z) + self.dense[k + 1](x))
        return z


_PRE_NORM_BIAS = re.compile(r"\.(dense|conv)(\.\d+)?\.bias$")


def pre_batchnorm_biases(keys):
    """The state_dict keys, among `keys`, of the Dense and Conv biases that
    a BatchNorm follows: `<path>.dense[.i].bias` or `<path>.conv[.i].bias`
    beside a `<path>.norm[.i]` (the DeepSets SetEncoder / SetDecoder, the
    MLP and conv blocks, the conv decoder's up-sampling steps). The
    BatchNorm subtracts the batch mean, so these biases' gradient is zero
    analytically and what a backward pass computes is roundoff."""
    keys = set(keys)
    return {k for k in keys
            if _PRE_NORM_BIAS.search(k)
            and _PRE_NORM_BIAS.sub(r".norm\2.weight", k) in keys}
