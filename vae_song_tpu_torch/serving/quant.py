"""Post-training int8 quantisation for decoding (port of
vae_song_tpu/serving/quant.py), `cli/generate.py --quant int8`.

  * weights: per-output-channel symmetric int8, quantised once
    (`quantize_dense_params`): column j of a Flax-layout kernel w [K, F]
    is w8[:, j] = round(w[:, j] / s_j), s_j = max|w[:, j]| / 127;
  * activations: per-token symmetric int8 at every call, s_x =
    max|x_row| / 127;
  * the product int8 x int8 -> int32, exact (`int8_matmul`): through
    `torch._int_mm` on the card, an int32 matmul on the CPU; then
    y32 * (s_x * s_j) + bias in f32, cast to the layer's output dtype.

Every rounding is JAX's: round half to even, clip to +-127, f32
division, so the int8 operands and the int32 product are bitwise JAX's
on the same inputs.

Which layers: the table (`quantize_dense_params`) holds every 2-D Flax
`kernel` with fan-in >= `min_fan_in` (16), keyed by its Flax module path
through vae_song_tpu_torch.weights, as JAX's table, so
`quantized_coverage` gives JAX's numbers. The decode serves from int8 the
port's `Dense` layers whose path is in the table (the layers whose
flax.linen.Dense JAX's interceptor replaces: the attention projections
and the wrapped Dense of every block). PositiveLinear's kernel is in the
table but its layer is not a Dense and stays float, as in JAX; so do the
paths that read a Dense's weights without calling it (the fused FFN, the
fused QKV projection), the MoE experts and router, convolutions and
norms. `make_quantized_decode` leaves the model as it is and decodes with
a copy.

`torch._int_mm` on the card takes a [M, K] by [K, N] product only for
M > 16 and K, N multiples of 8 (PyTorch's checks); the port pads the
operands with zero rows and columns up to those sizes and cuts the result
back, which changes no product. A shape it cannot pad to raises there.
"""

import copy

import torch
from torch import nn

from vae_song_tpu_torch import weights
from vae_song_tpu_torch.nn.blocks import Dense


def _quantize_kernel(w):
    """Per-output-channel symmetric int8 of a Flax-layout kernel [K, F]:
    (w8 int8 [K, F], scale f32 [F]), w ~= w8 * scale column by column."""
    wf = w.float()
    scale = torch.clamp(wf.abs().amax(dim=0) / 127.0, min=1e-12)
    return torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8), scale


def _kernels(model):
    """(Flax module path, Flax-layout kernel [K, F], bias or None) of every
    2-D `kernel` of `model`'s parameters."""
    sd = model.state_dict()
    for key, t in sd.items():
        _, path, _ = weights.flax_path(key)
        if path[-1] == "kernel" and t.dim() == 2:
            yield "/".join(path[:-1]), t.t(), sd.get(key[:-len("weight")] + "bias")


def quantize_dense_params(model, min_fan_in: int = 16) -> dict:
    """The quantised table {Flax module path: {"w8": int8 [K, F], "scale":
    f32 [F], "bias": f32 [F] or None}} of `model`'s 2-D kernels with fan-in
    >= `min_fan_in` (JAX `quantize_dense_params`), on the model's device."""
    table = {}
    with torch.no_grad():
        for path, kernel, bias in _kernels(model):
            if kernel.shape[0] >= min_fan_in:
                w8, scale = _quantize_kernel(kernel)
                table[path] = {"w8": w8, "scale": scale,
                               "bias": None if bias is None else bias.float().clone()}
    return table


def quantized_coverage(table: dict, model) -> tuple[int, int]:
    """(kernel elements served from int8, elements of every 2-D kernel)."""
    total = sum(kernel.numel() for _, kernel, _ in _kernels(model))
    return sum(e["w8"].numel() for e in table.values()), total


def quantize_activations(x):
    """Per-token symmetric int8 of x [..., K]: (x8 int8, s_x f32 [..., 1])."""
    xf = x.float()
    s_x = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0, min=1e-12)
    return torch.clamp(torch.round(xf / s_x), -127, 127).to(torch.int8), s_x


def _padded(a, rows: int, cols: int):
    """a with zero rows and columns appended up to [rows, cols]."""
    if a.shape == (rows, cols):
        return a
    out = a.new_zeros(rows, cols)
    out[:a.shape[0], :a.shape[1]] = a
    return out


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def int8_matmul(a, b):
    """a [M, K] int8 @ b [K, N] int8 -> int32 [M, N], exact: torch._int_mm
    on CUDA tensors (padded to its shape rules, the module's docstring),
    an int32 matmul on CPU tensors."""
    if not a.is_cuda:
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    (m, k), n = a.shape, b.shape[1]
    mp, kp, np_ = max(m, 17), _round_up(k, 8), _round_up(n, 8)
    y = torch._int_mm(_padded(a, mp, kp), _padded(b, kp, np_))
    return y[:m, :n]


def int8_dense(x, w8, w_scale, bias, out_dtype=None):
    """y = int8(x) @ w8 rescaled by s_x * w_scale, plus bias, in f32, cast
    to `out_dtype` (x's dtype when None); x [..., K], w8 [K, F] int8,
    w_scale [F] f32 (JAX `int8_dense`)."""
    x8, s_x = quantize_activations(x)
    y32 = int8_matmul(x8.reshape(-1, x8.shape[-1]), w8).reshape(*x.shape[:-1], w8.shape[1])
    y = y32.float() * (s_x * w_scale)
    if bias is not None:
        y = y + bias
    return y.to(out_dtype or x.dtype)


class Int8Dense(nn.Module):
    """A Dense served from int8. Its float `weight`, `bias` and `dtype` stay
    the layer's own, for the paths that read them without calling the
    layer (the fused FFN and fused QKV projection, which JAX's interceptor
    does not reach either)."""

    def __init__(self, dense: Dense, entry: dict):
        super().__init__()
        self.weight, self.bias, self.dtype = dense.weight, dense.bias, dense.dtype
        self.register_buffer("w8", entry["w8"])
        self.register_buffer("scale", entry["scale"])
        self.register_buffer("qbias", entry["bias"])

    def forward(self, x):
        # Dense's (and flax.linen.Dense's) output dtype
        out_dtype = self.dtype or torch.promote_types(x.dtype, self.weight.dtype)
        return int8_dense(x, self.w8, self.scale, self.qbias, out_dtype)


def make_quantized_decode(model, table: dict):
    """decode(z) of a copy of `model` whose Dense layers listed in `table`
    are Int8Dense (JAX `make_quantized_decode`), in eval mode under
    torch.no_grad(); the model itself is left as it is."""
    q = copy.deepcopy(model).eval()
    for name, module in list(q.named_modules()):
        if type(module) is not Dense:
            continue
        _, path, _ = weights.flax_path(name + ".weight")
        entry = table.get("/".join(path[:-1]))
        if entry is not None:
            parent, _, child = name.rpartition(".")
            setattr(q.get_submodule(parent), child, Int8Dense(module, entry))

    def decode(z):
        with torch.no_grad():
            return q.decode(z)

    return decode
