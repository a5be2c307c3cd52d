"""The port's train step on its two further routes against JAX's kernels in
interpret mode: the BHND attention (K3f / K3b; f32 at one head of 128,
bf16 at one head of 256 and of 320) and the fused FFN (K6f / K6b).
The helpers and bounds are tests/test_torch_train.py's (its docstring
says how the JAX side runs); the cases sit in files of their own so that
pytest-xdist's --dist loadfile spreads them over its workers."""

import functools

import numpy as np
import pytest
import torch

import vae_song_tpu.models.setvae as jax_setvae
from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from test_torch_train import (CPU_BF16_BOUNDS, KERNEL_BOUNDS, STEPS, _assert_within,
                              _count_calls, _patch_jax_kernels, _train_diffs)
from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu.ops import ffn as jax_ffn
from vae_song_tpu_torch.models import setvae as torch_setvae
from vae_song_tpu_torch.ops import attention as torch_attention


def test_train_step_bhnd_route_matches_jax_kernels_interpret(monkeypatch):
    """One 128-wide head (num_heads 1 at d_model 128), which the packed
    kernels refuse: the port's BHND route (the K3f / K3b plain versions)
    against the JAX BHND kernels in interpret mode (MultiHeadAttention's
    dense gate patched open, as for the packed one). Measured 2.1e-7,
    5.2e-4, 4.3e-6, 2.2e-3, 5.7e-3, 3.9e-3: within KERNEL_BOUNDS."""
    _patch_jax_kernels(monkeypatch)
    monkeypatch.setattr(jax_attention, "_dense_default_ok", jax_denseattn.dense_ok)
    jax_calls = _count_calls(monkeypatch, jax_denseattn, "dense_attention")
    monkeypatch.setattr(jax_denseattn, "dense_attention",
                        functools.partial(jax_denseattn.dense_attention, interpret=True))
    port_calls = _count_calls(monkeypatch, torch_attention, "dense_attention")
    _assert_within(_train_diffs(monkeypatch, "setvae", False, {"num_heads": 1}), KERNEL_BOUNDS)
    assert jax_calls and port_calls


def test_train_step_fused_ffn_matches_jax_kernels_interpret(monkeypatch):
    """VST_FUSED_FFN=1 with ff_dim 128 (fused_ffn_ok shapes): every
    encoder and decoder FFN of the port through `fused_ffn` (its plain
    versions), against the JAX fused FFN in interpret mode (its gate's
    TPU-backend check patched out, as tests/test_ffn_kernel.py does).
    Measured 1.9e-7, 8.2e-5, 1.4e-6, 4.3e-4, 1.3e-3, 2.8e-4: within
    KERNEL_BOUNDS."""
    _patch_jax_kernels(monkeypatch)
    monkeypatch.setattr(jax_ffn, "INTERPRET", True)
    monkeypatch.setattr(
        jax_setvae, "_use_fused_ffn",
        lambda x, f, dr, tr: (not (dr > 0.0 and tr))
        and jax_ffn.fused_ffn_ok(int(np.prod(x.shape[:-1])), x.shape[-1], f))
    monkeypatch.setenv("VST_FUSED_FFN", "1")
    jax_calls = _count_calls(monkeypatch, jax_ffn, "fused_ffn")
    port_calls = _count_calls(monkeypatch, torch_setvae, "fused_ffn")
    _assert_within(_train_diffs(monkeypatch, "setvae", False, {"ff_dim": 128}), KERNEL_BOUNDS)
    # per train step: 2 encoder and 2 decoder layers
    assert len(port_calls) == 4 * STEPS and jax_calls


@pytest.mark.parametrize("d_model", [256, 320, 576])
def test_bf16_train_step_one_wide_head_matches_jax_kernels_interpret(monkeypatch, one_thread,
                                                                      d_model):
    """One bf16 head of d_model (num_heads 1, mixed_precision): at 256 the
    bf16 `num_heads: 1` SetVAE step's head, whose kernels on the card are
    the wgmma kernels for heads of 192 and 256; at 320 a head that the
    wgmma kernels for heads of 320 to 512 take; at 576 one that the cluster
    kernels for heads of 576 to 2048 take. The port's BHND route (the
    K3f / K3b plain versions, which those kernels are held to on the card)
    against the JAX BHND kernels in interpret mode, bf16 on both sides: P
    and the GEMM outputs round at other points, as against JAX's CPU path,
    so CPU_BF16_BOUNDS hold it. Measured (one torch thread) at 256 3.3e-4,
    2.9e-2, 3.2e-2, 0.29, 3.8e-2, 0.52; at 320 9.8e-4, 3.5e-2, 3.4e-2,
    0.30, 3.8e-2, 0.51; at 576 5.3e-4, 0.17, 5.9e-2, 0.34, 3.8e-2, 0.73."""
    _patch_jax_kernels(monkeypatch)
    monkeypatch.setattr(jax_attention, "_dense_default_ok", jax_denseattn.dense_ok)
    jax_calls = _count_calls(monkeypatch, jax_denseattn, "dense_attention")
    monkeypatch.setattr(jax_denseattn, "dense_attention",
                        functools.partial(jax_denseattn.dense_attention, interpret=True))
    heads, attend = [], torch_attention.dense_attention
    monkeypatch.setattr(torch_attention, "dense_attention",
                        lambda q, *a, **k: heads.append((q.shape[-1], q.dtype)) or attend(q, *a,
                                                                                         **k))
    _assert_within(_train_diffs(monkeypatch, "setvae", True,
                                {"num_heads": 1, "d_model": d_model}), CPU_BF16_BOUNDS)
    assert jax_calls and heads and set(heads) == {(d_model, torch.bfloat16)}
