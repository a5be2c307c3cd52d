"""The port's Hopper kernels against their plain PyTorch versions on the
card. Marked `cuda`; they skip on a machine without a CUDA card. The
machine with the card has no jax, and tests/conftest.py imports it, so
run them there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math

import pytest
import torch

from vae_song_tpu_torch.ops import chamfer, denseattn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.parametrize("b,n,h,dtype", [
    (1, 2048, 4, torch.bfloat16), (3, 256, 2, torch.bfloat16),
    (2, 128, 6, torch.bfloat16), (2, 256, 2, torch.float32), (1, 64, 2, torch.float32),
])
def test_dense_attention_kernel_matches_plain(dev, b, n, h, dtype):
    gen = torch.Generator(device=dev).manual_seed(n + h)
    q, k, v = ((torch.randn(b, n, h * 64, generator=gen, device=dev) * s).to(dtype)
               .view(b, n, h, 64) for s in (2.0, 2.0, 1.0))
    before = denseattn.dense_attention_fwd.launches
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert denseattn.dense_attention_fwd.launches == before + 1
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, 0.125)
    # bf16: P rounded against the running max (kernel) or the final max
    # (plain), see chip_smoke.py; f32: summation order only
    o_tol, l_tol = (2.0 ** -6, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    assert (o.float() - o_ref.float()).abs().max() <= o_tol * max(1.0, o_ref.float().abs().max())
    assert (lse - lse_ref).abs().max() <= l_tol * max(1.0, lse_ref.abs().max())


def test_dense_attention_reads_strided_heads(dev):
    qkv = torch.randn(2, 256, 3 * 128, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].view(2, 256, 2, 64) for i in range(3))
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    o2, lse2 = denseattn.dense_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def test_dense_attention_refuses_grad(dev):
    q = torch.randn(1, 128, 2, 64, device=dev, requires_grad=True)
    with pytest.raises(NotImplementedError):
        denseattn.dense_attention_fwd(q, q, q, 0.125)


@pytest.mark.parametrize("b,np_,ng", [(64, 2048, 2048), (3, 1000, 77), (2, 5, 2048)])
def test_chamfer_kernel_matches_plain_bitwise(dev, b, np_, ng):
    gen = torch.Generator(device=dev).manual_seed(np_ + ng)
    pred = torch.randn(b, np_, 3, generator=gen, device=dev)
    gt = torch.randn(b, ng, 3, generator=gen, device=dev)
    before = chamfer.chamfer_nn_packed.launches
    got = chamfer.chamfer_nn_packed(pred, gt)
    torch.cuda.synchronize()
    assert chamfer.chamfer_nn_packed.launches == before + 2
    want = chamfer.chamfer_nn_packed_plain(pred, gt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_best_chamfer_takes_kernel_on_card(dev):
    pred = torch.randn(2, 512, 3, device=dev)
    gt = torch.randn(2, 512, 3, device=dev)
    before = chamfer.chamfer_nn_packed.launches
    val = float(chamfer.best_chamfer(pred, gt))
    assert chamfer.chamfer_nn_packed.launches == before + 2
    assert math.isclose(val, float(chamfer.chamfer_distance(pred, gt)), rel_tol=2.0 ** -11)
