"""Fused transformer FFN: the port of vae_song_tpu/ops/ffn.py's kernels,
the forward (`_ffn_fwd_kernel`, K6f) and the backward (`_ffn_bwd_kernel`,
K6b), to hand-written Hopper kernels (csrc/ffn_fwd.cu, csrc/ffn_bwd.cu),
each with its plain PyTorch version beside it.

    y = x + relu(x W1 + b1) W2 + b2

with the TPU kernels' roundings (cd = the inputs' dtype):

    h32  = relu(x W1 + b1)                f32 sums, the bias added in f32
    h    = round_cd(h32)
    y    = (round_cd(h W2) + b2) + x      two adds in cd, left to right

    dh32 = (dy W2^T) * [h32 > 0],  dh = round_cd(dh32)
    dx   = round_cd(dh W1^T) + dy
    dW1  = x^T dh,  dW2 = h^T dy,  db1 = colsum(dh32),  db2 = colsum(dy)
                                          f32 sums, rounded to cd once

The unfused `Dense` -> ReLU -> `Dense` path rounds x W1 before it adds
b1; the fused one does not, so the two differ by bf16 roundings (the JAX
package's fused arm differs from its unfused one the same way).

The weights are taken in the port's Dense layout, so no transposed copy
is made: w1 is ff_up.weight [F, D] (W1 transposed) and w2 ff_down.weight
[D, F]; their gradients come back in the same layout. All five operands
share x's dtype (float32 or bfloat16); the caller casts the parameters to
the compute dtype, as Dense does.

`fused_ffn` is differentiable: a torch.autograd.Function whose forward is
K6f and whose backward is K6b on CUDA tensors (the plain versions on CPU
tensors). The kernels take every shape the gate `fused_ffn_ok` accepts
(rows, width and hidden width multiples of 128): a block recomputes h per
128- or 256-wide column chunk of y and dx where D is wider than 256.
bf16 runs wgmma/TMA kernels; f32 (`mixed_precision: false`) split-TF32
mma.sync kernels (csrc/mma_tf32.cuh: every product three TF32 products, 8
terms a step into a fresh accumulator), whose launches are also counted on
`tf32_fwd` and `tf32_bwd`.
"""

import types

import torch

from vae_song_tpu_torch import _kernels

# the backward's weight-gradient pass, by dtype: its output tile edge and
# the blocks one streaming multiprocessor holds at once (both kernels take
# 128 x 128 tiles and a whole SM: the bf16 wgmma kernel's 197 KB and the
# f32 split-TF32 kernel's 4-stage ring of 136 KB); in f32 also the most
# rows a split sums in sequence (16384 a split, at the f32 path's M =
# 131072, left dW1 and dW2 farther from float64 than the plain version's)
WGRAD_TILE = {torch.bfloat16: 128, torch.float32: 128}
WGRAD_BLOCKS_PER_SM = {torch.bfloat16: 1, torch.float32: 1}
WGRAD_SPLIT_ROWS = {torch.bfloat16: None, torch.float32: 2048}

# Launches of the f32 kernels (split TF32), also counted on fused_ffn_fwd
# and fused_ffn_bwd.
tf32_fwd = types.SimpleNamespace(launches=0)
tf32_bwd = types.SimpleNamespace(launches=0)


def fused_ffn_ok(m: int, d: int, f: int) -> bool:
    """The JAX package's gate for its fused FFN kernel (ops/ffn.py:72):
    lane-aligned widths, a row count it can block, and both weight
    matrices within 32 MiB."""
    return (
        d % 128 == 0
        and f % 128 == 0
        and m % 128 == 0
        and m >= 1024
        and 2 * d * f * 4 <= 32 * 1024 * 1024
    )


def _check(x2, w1, b1, w2, b2=None):
    m, d = x2.shape
    f = w1.shape[0]
    shapes = {"w1": (w1, (f, d)), "b1": (b1, (f,)), "w2": (w2, (d, f))}
    if b2 is not None:
        shapes["b2"] = (b2, (d,))
    for name, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name} must be {list(want)} for x [{m}, {d}], got {list(t.shape)}")
        if t.dtype != x2.dtype:
            raise TypeError(f"{name} must be {x2.dtype} like x, got {t.dtype}")
        if t.device != x2.device:
            raise ValueError(f"{name} must lie on x's device {x2.device}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    if m % 128 or d % 128 or f % 128 or 0 in (m, d, f):
        raise ValueError(f"rows, width and hidden width must be positive multiples of 128, "
                         f"got {m}, {d}, {f}")


def fused_ffn_plain(x2, w1, b1, w2, b2):
    """Plain PyTorch version of the forward kernel: x2 [M, D], w1 [F, D],
    b1 [F], w2 [D, F], b2 [D] in one dtype; returns y [M, D]."""
    _check(x2, w1, b1, w2, b2)
    dt = x2.dtype
    h = torch.relu(x2.float() @ w1.float().t() + b1.float()).to(dt)
    return ((h.float() @ w2.float().t()).to(dt) + b2) + x2


def fused_ffn_bwd_plain(x2, dy, w1, b1, w2):
    """Plain PyTorch version of the backward kernel: returns (dx [M, D],
    dw1 [F, D], db1 [F], dw2 [D, F], db2 [D]) in x2's dtype."""
    _check(x2, w1, b1, w2)
    dt = x2.dtype
    xf, dyf = x2.float(), dy.float()
    h32 = torch.relu(xf @ w1.float().t() + b1.float())
    dh32 = (dyf @ w2.float()) * (h32 > 0).float()
    dh = dh32.to(dt)
    dx = (dh.float() @ w1.float()).to(dt) + dy
    dw1 = (dh.float().t() @ xf).to(dt)
    dw2 = (dyf.t() @ h32.to(dt).float()).to(dt)
    return dx, dw1, dh32.sum(0).to(dt), dw2, dyf.sum(0).to(dt)


def _kernel_operands(*ts):
    _kernels.check_device(ts[0])
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("the FFN kernels take contiguous operands on 16-byte boundaries")


def _launch_fwd(x2, w1, b1, w2, b2):
    _kernel_operands(x2, w1, b1, w2, b2)
    m, d = x2.shape
    y = torch.empty_like(x2)
    _kernels.launch(
        "vst_ffn_fwd", x2.device, int(x2.dtype == torch.bfloat16), x2.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), b2.data_ptr(), y.data_ptr(),
        m, d, w1.shape[0],
    )
    return y


def wgrad_splits(m: int, d: int, f: int, dtype, sms: int) -> int:
    """Splits of the M rows in the backward's weight-gradient pass: enough
    blocks over the output tiles of dW1 and dW2 to fill the card's `sms`
    streaming multiprocessors once, and in f32 enough that none sums more
    than WGRAD_SPLIT_ROWS rows; each split at least one 64-row step."""
    tile = WGRAD_TILE[dtype]
    tiles = 2 * (f // tile) * (d // tile)
    splits = sms * WGRAD_BLOCKS_PER_SM[dtype] // tiles
    if WGRAD_SPLIT_ROWS[dtype]:
        splits = max(splits, -(-m // WGRAD_SPLIT_ROWS[dtype]))
    return max(1, min(m // 64, splits))


def _launch_bwd(x2, dy, w1, b1, w2):
    _kernel_operands(x2, dy, w1, b1, w2)
    m, d = x2.shape
    f = w1.shape[0]
    dev, dt = x2.device, x2.dtype
    splits = wgrad_splits(m, d, f, dt, torch.cuda.get_device_properties(dev).multi_processor_count)
    dx = torch.empty_like(x2)
    dw1, db1 = torch.empty_like(w1), torch.empty_like(b1)
    dw2, db2 = torch.empty_like(w2), torch.empty(d, dtype=dt, device=dev)
    # scratch: h and dh for the weight-gradient pass, and f32 partials
    hbuf, dhbuf = (torch.empty((m, f), dtype=dt, device=dev) for _ in range(2))
    pb1 = torch.empty((m // 64, f), dtype=torch.float32, device=dev)
    pb2 = torch.empty((m // 64, d), dtype=torch.float32, device=dev)
    pw1 = torch.empty((splits, f, d), dtype=torch.float32, device=dev)
    pw2 = torch.empty((splits, d, f), dtype=torch.float32, device=dev)
    _kernels.launch(
        "vst_ffn_bwd", dev, int(dt == torch.bfloat16), x2.data_ptr(), dy.data_ptr(),
        w1.data_ptr(), b1.data_ptr(), w2.data_ptr(), dx.data_ptr(), dw1.data_ptr(),
        db1.data_ptr(), dw2.data_ptr(), db2.data_ptr(), hbuf.data_ptr(), dhbuf.data_ptr(),
        pb1.data_ptr(), pb2.data_ptr(), pw1.data_ptr(), pw2.data_ptr(), m, d, f, splits,
    )
    return dx, dw1, db1, dw2, db2


def fused_ffn_fwd(x2, w1, b1, w2, b2):
    """y = x2 + relu(x2 W1 + b1) W2 + b2 on [M, D] rows, not
    differentiable. CUDA tensors launch the Hopper kernel (one more on
    `fused_ffn_fwd.launches`, and in f32 on `tf32_fwd.launches`); CPU
    tensors take the plain version."""
    _check(x2, w1, b1, w2, b2)
    if x2.device.type == "cpu":
        return fused_ffn_plain(x2, w1, b1, w2, b2)
    y = _launch_fwd(x2, w1, b1, w2, b2)
    fused_ffn_fwd.launches += 1
    if x2.dtype == torch.float32:
        tf32_fwd.launches += 1
    return y


def fused_ffn_bwd(x2, dy, w1, b1, w2):
    """(dx, dw1, db1, dw2, db2) of the fused FFN for the output cotangent
    dy. CUDA tensors launch the Hopper kernels (one more on
    `fused_ffn_bwd.launches`, and in f32 on `tf32_bwd.launches`); CPU
    tensors take the plain version."""
    _check(x2, w1, b1, w2)
    if dy.shape != x2.shape or dy.dtype != x2.dtype or dy.device != x2.device:
        raise ValueError(f"dy must be x's {x2.dtype} {list(x2.shape)} on {x2.device}, got "
                         f"{dy.dtype} {list(dy.shape)} on {dy.device}")
    if x2.device.type == "cpu":
        return fused_ffn_bwd_plain(x2, dy, w1, b1, w2)
    out = _launch_bwd(x2, dy.contiguous(), w1, b1, w2)
    fused_ffn_bwd.launches += 1
    if x2.dtype == torch.float32:
        tf32_bwd.launches += 1
    return out


class _FusedFFN(torch.autograd.Function):
    """Forward K6f, backward K6b (or their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x2, w1, b1, w2, b2):
        ctx.save_for_backward(x2, w1, b1, w2)
        return fused_ffn_fwd(x2, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dy):
        x2, w1, b1, w2 = ctx.saved_tensors
        return fused_ffn_bwd(x2, dy, w1, b1, w2)


def fused_ffn(x, w1, b1, w2, b2):
    """x + relu(x W1 + b1) W2 + b2 over the last axis of x [..., D], with
    w1 = ff_up.weight [F, D], b1 [F], w2 = ff_down.weight [D, F], b2 [D],
    all in x's dtype; differentiable in all five (the port of the JAX
    package's `fused_ffn`). Callers gate on `fused_ffn_ok`."""
    d = x.shape[-1]
    y = _FusedFFN.apply(x.reshape(-1, d).contiguous(), w1.contiguous(), b1.contiguous(),
                        w2.contiguous(), b2.contiguous())
    return y.reshape(x.shape)


fused_ffn_fwd.launches = 0
fused_ffn_bwd.launches = 0
