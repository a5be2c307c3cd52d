"""The port's dense attention forward (vae_song_tpu_torch/ops/denseattn.py)
against the JAX package's packed Pallas kernel (`_call_fwd_packed`) run
in interpret mode, on the same numpy inputs. On the CPU the port's
wrapper takes its plain version, which must compute the kernel's
function: O, and the base-2 LSE that JAX splits into lse_a / lse_b
(heads 2j and 2j + 1)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.ops import denseattn

N, H, D = 256, 2, 64
SCALE = 1.0 / np.sqrt(D)

# f32: the same math in another summation order; measured max |dO|
# 2.6e-6 at |O| <= 4, max |dLSE| 1.9e-6 at |LSE| <= 30.
F32_ATOL, F32_RTOL = 1e-5, 1e-6
# bf16: O rounds to bf16 on both sides (measured: at most 1 ulp, 0.0156
# at |O| ~ 3.5); bound 2^-6 of max(1, max|O|). The LSE differs more
# because jnp.exp2 on bf16 lowers to exp(bf16(ln 2) * x) under XLA on the
# CPU (ln 2 rounded to 0.6914), which the port does not copy: measured
# max |dLSE| 8.3e-3 at |LSE| ~ 28; bound 1e-3 of max(1, max|LSE|).
BF16_O_TOL, BF16_LSE_TOL = 2.0 ** -6, 1e-3


def _inputs(b, seed):
    rng = np.random.default_rng(seed)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    return [(rng.normal(size=(b, N, H * D)) * s).astype(np.float32) for s in (2.0, 2.0, 1.0)]


def _jax_ref(q, k, v, jdt):
    o, lse_a, lse_b = jax_denseattn._call_fwd_packed(
        *(jnp.asarray(a, jdt) for a in (q, k, v)), SCALE, True
    )
    b = q.shape[0]
    lse = np.stack([np.asarray(lse_a)[..., 0], np.asarray(lse_b)[..., 0]], axis=2)
    return np.asarray(o.astype(jnp.float32)), lse.reshape(b, H, N)


def _port(q, k, v, dt):
    b = q.shape[0]
    t = [torch.from_numpy(a).to(dt).view(b, N, H, D) for a in (q, k, v)]
    o, lse = denseattn.dense_attention_fwd(*t, SCALE)
    assert o.shape == (b, N, H, D) and o.dtype == dt
    assert lse.shape == (b, H, N) and lse.dtype == torch.float32
    return o.float().reshape(b, N, H * D).numpy(), lse.numpy()


@pytest.mark.parametrize("b", [1, 2])
def test_plain_matches_pallas_f32(b):
    q, k, v = _inputs(b, seed=b)
    o_ref, lse_ref = _jax_ref(q, k, v, jnp.float32)
    o, lse = _port(q, k, v, torch.float32)
    np.testing.assert_allclose(o, o_ref, atol=F32_ATOL, rtol=F32_RTOL)
    np.testing.assert_allclose(lse, lse_ref, atol=F32_ATOL, rtol=F32_RTOL)


@pytest.mark.parametrize("b", [1, 2])
def test_plain_matches_pallas_bf16(b):
    q, k, v = _inputs(b, seed=10 + b)
    o_ref, lse_ref = _jax_ref(q, k, v, jnp.bfloat16)
    o, lse = _port(q, k, v, torch.bfloat16)
    assert np.abs(o - o_ref).max() <= BF16_O_TOL * max(1.0, np.abs(o_ref).max())
    assert np.abs(lse - lse_ref).max() <= BF16_LSE_TOL * max(1.0, np.abs(lse_ref).max())


def test_strided_views_match_contiguous():
    """Head views of one packed [B, N, 3*H*D] projection (non-contiguous
    q/k/v) give the result of contiguous copies."""
    rng = np.random.default_rng(3)
    qkv = torch.from_numpy(rng.normal(size=(2, N, 3 * H * D)).astype(np.float32))
    q, k, v = (qkv[..., i * H * D:(i + 1) * H * D].view(2, N, H, D) for i in range(3))
    o, lse = denseattn.dense_attention_fwd(q, k, v, SCALE)
    o2, lse2 = denseattn.dense_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), SCALE)
    torch.testing.assert_close(o, o2, atol=0, rtol=0)
    torch.testing.assert_close(lse, lse2, atol=0, rtol=0)


@pytest.mark.parametrize("shape", [
    (2048, 2048, 4, 64), (2048, 2048, 3, 64), (2048, 2048, 4, 128),
    (2048, 1, 4, 64), (4096, 4096, 4, 64), (200, 200, 2, 64), (256, 256, 2, 64),
])
def test_gate_matches_jax(shape):
    assert denseattn.packed_ok(*shape) == jax_denseattn.packed_ok(*shape)


def test_cpu_tensors_never_count_launches():
    before = denseattn.dense_attention_fwd.launches
    q, k, v = _inputs(1, seed=0)
    _port(q, k, v, torch.float32)
    _port(q, k, v, torch.bfloat16)
    assert denseattn.dense_attention_fwd.launches == before


@pytest.mark.parametrize("bad", ["head_width", "seq_len", "dtype_mix", "shape_mix"])
def test_wrapper_rejects(bad):
    x = torch.zeros(1, 128, 2, 64)
    q, k, v = x, x.clone(), x.clone()
    if bad == "head_width":
        q = k = v = torch.zeros(1, 128, 4, 32)
    elif bad == "seq_len":
        q = k = v = torch.zeros(1, 100, 2, 64)
    elif bad == "dtype_mix":
        k = k.to(torch.bfloat16)
    else:
        k = torch.zeros(1, 256, 2, 64)
    with pytest.raises((ValueError, TypeError)):
        denseattn.dense_attention_fwd(q, k, v, SCALE)


def test_kernel_library_path_and_device_check():
    """The library's name follows the sources (building needs nvcc and
    happens only at first launch), and a CPU tensor is refused by the
    device check the wrappers run before a launch."""
    path = _kernels.library_path()
    assert path.parent == _kernels.BUILD_DIR and path == _kernels.library_path()
    with pytest.raises(ValueError):
        _kernels.check_device(torch.zeros(1))
