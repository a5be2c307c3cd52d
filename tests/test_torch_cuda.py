"""The port's Hopper kernels against their plain PyTorch versions on the
card. Marked `cuda`; they skip on a machine without a CUDA card. The
machine with the card has no jax, and tests/conftest.py imports it, so
run them there without the conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import math
import os

import pytest
import torch

from vae_song_tpu_torch.ops import chamfer, denseattn, ffn

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _packed_views(b, n, h, d, dtype, gen, dev):
    """q, k, v as views of one [B, N, 3 H D] projection, as the model's
    fused projection would give them."""
    qkv = (torch.randn(b, n, 3 * h * d, generator=gen, device=dev) * 2).to(dtype)
    return [qkv[..., i * h * d:(i + 1) * h * d].view(b, n, h, d) for i in range(3)]


@pytest.mark.parametrize("b,n,h,dtype,strided", [
    (1, 2048, 4, torch.bfloat16, False), (3, 256, 2, torch.bfloat16, False),
    (2, 128, 6, torch.bfloat16, False), (2, 256, 2, torch.float32, False),
    (1, 64, 2, torch.float32, False),
    # an odd number of 64-row tiles: the last 128-key tile holds keys past
    # N, which must not enter the softmax; at B = 48 and 40 the blocks
    # hold two 64-row warpgroups, the second of the last block on rows
    # past N
    (2, 192, 2, torch.bfloat16, False), (1, 320, 4, torch.bfloat16, True),
    (48, 192, 2, torch.bfloat16, True), (40, 320, 2, torch.bfloat16, False),
    # views of one fused projection, at B = 1 on the shipped length too
    (2, 256, 4, torch.bfloat16, True), (1, 2048, 4, torch.bfloat16, True),
])
def test_dense_attention_kernel_matches_plain(dev, b, n, h, dtype, strided):
    gen = torch.Generator(device=dev).manual_seed(n + h)
    if strided:
        q, k, v = _packed_views(b, n, h, 64, dtype, gen, dev)
    else:
        q, k, v = ((torch.randn(b, n, h * 64, generator=gen, device=dev) * s).to(dtype)
                   .view(b, n, h, 64) for s in (2.0, 2.0, 1.0))
    before = denseattn.dense_attention_fwd.launches
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    torch.cuda.synchronize()
    assert denseattn.dense_attention_fwd.launches == before + 1
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, 0.125)
    # bf16: P rounded against the running max (kernel) or the final max
    # (plain), see chip_smoke.py; f32: split-TF32 products (f32-accurate)
    # summed in another order
    o_tol, l_tol = (2.0 ** -6, 1e-3) if dtype == torch.bfloat16 else (1e-5, 1e-5)
    assert (o.float() - o_ref.float()).abs().max() <= o_tol * max(1.0, o_ref.float().abs().max())
    assert (lse - lse_ref).abs().max() <= l_tol * max(1.0, lse_ref.abs().max())
    o2, lse2 = denseattn.dense_attention_fwd(q, k, v, 0.125)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)          # no atomics


def test_dense_attention_reads_strided_heads(dev):
    qkv = torch.randn(2, 256, 3 * 128, device=dev).to(torch.bfloat16)
    q, k, v = (qkv[..., i * 128:(i + 1) * 128].view(2, 256, 2, 64) for i in range(3))
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    o2, lse2 = denseattn.dense_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), 0.125)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)


def _attn_bwd_inputs(dev, b, n, h, dtype, strided, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if strided:       # q/k/v as views of one packed projection, as the model gives them
        q, k, v = _packed_views(b, n, h, 64, dtype, gen, dev)
    else:
        q, k, v = ((torch.randn(b, n, h * 64, generator=gen, device=dev) * s).to(dtype)
                   .view(b, n, h, 64) for s in (2.0, 2.0, 1.0))
    do = torch.randn(b, n, h, 64, generator=gen, device=dev).to(dtype)
    return q, k, v, do


@pytest.mark.parametrize("b,n,h,dtype,strided", [
    (1, 2048, 4, torch.bfloat16, False), (2, 256, 2, torch.bfloat16, True),
    (3, 128, 6, torch.bfloat16, False), (2, 256, 2, torch.float32, True),
    # an odd number of 64-row tiles (the last 128-row block half empty)
    (2, 192, 2, torch.bfloat16, False), (1, 192, 4, torch.bfloat16, True),
    (1, 2048, 2, torch.bfloat16, True),
])
def test_dense_attention_bwd_kernel_matches_plain(dev, b, n, h, dtype, strided):
    q, k, v, do = _attn_bwd_inputs(dev, b, n, h, dtype, strided, seed=n + h)
    o, lse = denseattn.dense_attention_fwd(q, k, v, 0.125)
    before = denseattn.dense_attention_bwd.launches
    got = denseattn.dense_attention_bwd(q, k, v, o, lse, do, 0.125)
    torch.cuda.synchronize()
    assert denseattn.dense_attention_bwd.launches == before + 1
    want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, 0.125)
    # bf16: a rounded exp2 argument or dP one bf16 ulp apart (see
    # chip_smoke.py); f32: split-TF32 products summed in another order
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        assert (g.float() - w.float()).abs().max() <= tol * w.float().abs().max()
    again = denseattn.dense_attention_bwd(q, k, v, o, lse, do, 0.125)
    assert all(torch.equal(a, g) for a, g in zip(again, got))     # no atomics


def test_dense_attention_grads_through_kernels(dev):
    """Autograd through the Function: K1 forward, K2 backward, against
    autograd through the plain forward, f32."""
    qkv = torch.randn(2, 256, 3 * 128, device=dev, requires_grad=True)
    w = torch.randn(2, 256, 2, 64, device=dev)
    views = lambda t: [t[..., i * 128:(i + 1) * 128].view(2, 256, 2, 64) for i in range(3)]
    before = denseattn.dense_attention_bwd.launches
    o, _ = denseattn.dense_attention_fwd(*views(qkv), 0.125)
    (got,) = torch.autograd.grad((o * w).sum(), qkv)
    assert denseattn.dense_attention_bwd.launches == before + 1
    o_ref, _ = denseattn.dense_attention_fwd_plain(*views(qkv), 0.125)
    (want,) = torch.autograd.grad((o_ref * w).sum(), qkv)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()


@pytest.mark.parametrize("b,n,dup", [(64, 2048, False), (8, 128, True)])
def test_chamfer_bwd_kernel_matches_plain(dev, b, n, dup):
    gen = torch.Generator(device=dev).manual_seed(n)
    pred = torch.randn(b, n, 3, generator=gen, device=dev)
    gt = torch.randn(b, n, 3, generator=gen, device=dev)
    if dup:           # many gt points share a nearest pred point
        gt[:, : n // 2] = pred[:, :4].repeat(1, n // 8, 1) + 1e-3
    _, argp, _, argg = chamfer.chamfer_nn_packed(pred, gt)
    before = chamfer.chamfer_bwd.launches
    got = chamfer.chamfer_bwd(pred, gt, argp, argg)
    torch.cuda.synchronize()
    assert chamfer.chamfer_bwd.launches == before + 1
    want = chamfer.chamfer_bwd_plain(pred, gt, argp, argg)
    # the plain version's index_add adds with atomics in another order
    for g, w in zip(got, want):
        assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    again = chamfer.chamfer_bwd(pred, gt, argp, argg)
    assert all(torch.equal(a, g) for a, g in zip(again, got))     # run to run


@pytest.mark.parametrize("b,np_,ng,inputs", [
    (8, 2048, 2048, "all_to_one"), (8, 2048, 128, "random"), (4, 128, 2048, "random"),
    (64, 2048, 2048, "random"), (64, 2048, 2048, "dup"),
])
def test_chamfer_bwd_kernel_matches_cpu_plain_bitwise(dev, b, np_, ng, inputs):
    """K5 against the plain version run on the CPU, whose index_add adds
    in ascending index order as the kernel's inverse lists do: bitwise
    (the denominators B N are powers of two here), also where one pred
    point is every gt point's nearest (one list of 2048 sources) and at
    Np != Ng; on random clouds also within K5_TOL of the plain version on
    the card, whose index_add adds with atomics, so that long lists move it
    off the ordered sum by about K5_TOL (chip_smoke.py phase 3 prints it
    on skewed clouds): there the CPU run is the reference; and the same
    bits from run to run."""
    gen = torch.Generator(device=dev).manual_seed(np_ + 3 * ng)
    pred = torch.randn(b, np_, 3, generator=gen, device=dev)
    gt = torch.randn(b, ng, 3, generator=gen, device=dev)
    if inputs == "all_to_one":
        pred[:, 1:] += 100.0
        gt = pred[:, :1] + 1e-3 * torch.rand(b, ng, 3, generator=gen, device=dev)
    if inputs == "dup":
        gt[:, : ng // 2] = pred[:, :4].repeat(1, ng // 8, 1) + 1e-3
    _, argp, _, argg = chamfer.chamfer_nn_packed(pred, gt)
    if inputs == "all_to_one":
        assert bool((argg == 0).all())
    got = chamfer.chamfer_bwd(pred, gt, argp, argg)
    want = chamfer.chamfer_bwd_plain(pred.cpu(), gt.cpu(), argp.cpu(), argg.cpu())
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    if inputs == "random":
        for g, w in zip(got, chamfer.chamfer_bwd_plain(pred, gt, argp, argg)):
            assert (g - w).abs().max() <= 1e-6 * w.abs().max()
    again = chamfer.chamfer_bwd(pred, gt, argp, argg)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


ALL_COUNTERS = (denseattn.dense_attention_fwd, denseattn.dense_attention_bwd,
                denseattn.dense_attention_bhnd, denseattn.dense_attention_bwd_bhnd,
                chamfer.chamfer_nn_packed, chamfer.chamfer_bwd,
                ffn.fused_ffn_fwd, ffn.fused_ffn_bwd)


def _train_step_launches(dev, n_micro=1, dropout=False, kind="setvae", **overrides):
    """One SetVAE train step on the card with the given model params (with
    n_micro > 1 the accumulated step over 8 clouds a microbatch; with
    `dropout`, keep masks from a CUDA generator): finite loss terms, every
    parameter with a gradient moved; returns the launches of each kernel
    of ALL_COUNTERS."""
    from vae_song_tpu_torch.models.registry import build_model
    from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
    from vae_song_tpu_torch.train.state import make_optimizer
    from vae_song_tpu_torch.train.steps import make_accum_train_step

    mp = dict(latent_channel=16, num_points=256, d_model=128, num_heads=2,
              num_encoder_layers=2, num_decoder_layers=2, ff_dim=64, mixed_precision=True)
    mp.update(overrides)
    model = build_model(kind, "shapenet", mp, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    before = {k: v.detach().clone() for k, v in model.named_parameters()}
    step = make_accum_train_step(model, make_optimizer(model.parameters(), lr=1e-2), n_micro)
    start = [f.launches for f in ALL_COUNTERS]
    gen = torch.Generator(device=dev).manual_seed(1)
    # 8 clouds a microbatch: a batch the packed Chamfer gate takes (B % 8 == 0)
    b = 8 * n_micro
    out = step(torch.randn(b, 256, 3, generator=gen, device=dev),
               torch.randn(b, 16, generator=gen, device=dev), 0.5,
               torch.Generator(device=dev).manual_seed(2) if dropout else None)
    assert all(math.isfinite(float(v)) for v in out.values())
    # a key bias, and a Dense bias that a BatchNorm follows, have an
    # analytically zero gradient (roundoff only)
    pre_bn = pre_batchnorm_biases(before)
    for name, p in model.named_parameters():
        # the cross-attention's query and key: softmax over one key is 1,
        # so their gradient is none, or with dropout exactly zero
        one_key = "cross_attn.query" in name or "cross_attn.key" in name
        if p.grad is not None and not name.endswith("key.bias") and not (
                name in pre_bn or one_key):
            assert not torch.equal(p.detach(), before[name]), name
    if dropout:
        # the materialised scores give every parameter a gradient, as in JAX
        assert all(p.grad is not None for p in model.parameters())
    return [f.launches - s for f, s in zip(ALL_COUNTERS, start)]


def test_train_step_runs_the_kernels(dev):
    """The default route: each of K1, K2, K4, K5 launched, nothing else.
    2 encoder + 2 decoder self-attentions; the Chamfer forward is one
    launch for both sides."""
    assert _train_step_launches(dev) == [4, 4, 0, 0, 1, 1, 0, 0]


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_deepsets_train_step_runs_the_chamfer_kernels(dev, kind):
    """The DeepSets models (use_attention false): K4 and K5 only (SetLRVAE
    computes one Chamfer loss too)."""
    launches = _train_step_launches(dev, kind=kind, use_attention=False,
                                    encoder_hidden=[32, 64], decoder_hidden=[64, 32])
    assert launches == [0, 0, 0, 0, 1, 1, 0, 0]


def test_dropout_train_step_runs_no_attention_kernel(dev):
    """attn_dropout > 0 in training: every attention materialises its
    scores (no K1, K2); the Chamfer kernels run."""
    assert _train_step_launches(dev, dropout=True, attn_dropout=0.1) == [0, 0, 0, 0, 1, 1, 0, 0]


def test_dropout_draws_its_mask_on_the_card(dev):
    """A CUDA generator draws the keep mask on the card; a CPU generator
    for a tensor on the card raises."""
    from vae_song_tpu_torch.nn.blocks import dropout

    x = torch.ones(64, 64, device=dev)
    a = dropout(x, 0.25, torch.Generator(device=dev).manual_seed(3))
    assert a.device == x.device and 0.7 < float((a > 0).float().mean()) < 0.8
    with pytest.raises(ValueError):
        dropout(x, 0.25, torch.Generator().manual_seed(3))


def test_accum_train_step_runs_the_kernels_per_microbatch(dev):
    """grad_accum 2: K1, K2, K4 and K5 once a microbatch each."""
    assert _train_step_launches(dev, n_micro=2) == [8, 8, 0, 0, 2, 2, 0, 0]


def test_resume_on_card_replays_the_continuous_run(dev, tmp_path):
    """train_and_test on the card with checkpoint_every, async_checkpoint
    and grad_accum, then a fresh model resumed from the first checkpoint:
    the same final state bit for bit (every kernel is repeatable)."""
    from vae_song_tpu_torch.models.registry import build_model
    from vae_song_tpu_torch.train.loop import train_and_test
    from vae_song_tpu_torch.train.state import adam_state

    mp = dict(latent_channel=16, num_points=256, d_model=128, num_heads=2,
              num_encoder_layers=2, num_decoder_layers=2, ff_dim=64, mixed_precision=True)
    kw = dict(epochs=2, batch_size=16, dataset_name="shapenet", seed=3, device=dev,
              grad_accum=2, dataset_params={"fake": True, "num_points": 256,
                                            "num_samples": 32, "num_test_samples": 16})
    mk = lambda seed: build_model("setlrvae", "shapenet", mp,
                                  generator=torch.Generator().manual_seed(seed))
    cont, summary = train_and_test(mk(0), output_root=str(tmp_path / "a"), checkpoint_every=1,
                                   async_checkpoint=True, **kw)
    ckpt = os.path.join(summary["result_dir"], "params", "ckpt_0.pkl")
    resumed, _ = train_and_test(mk(1), output_root=str(tmp_path / "b"), resume_from=ckpt, **kw)
    for (k, v), w in zip(cont.model.state_dict().items(), resumed.model.state_dict().values()):
        assert torch.equal(v, w), k
    for name in ("mu", "nu"):
        for k, v in adam_state(cont)[name].items():
            assert torch.equal(v, adam_state(resumed)[name][k]), (name, k)
    assert cont.step == resumed.step == 4


def test_train_step_with_wide_heads_runs_the_bhnd_kernels(dev):
    """One head of 128 (num_heads 1 at d_model 128): K3f and K3b in place
    of K1 and K2."""
    assert _train_step_launches(dev, num_heads=1) == [0, 0, 4, 4, 1, 1, 0, 0]


def test_f32_train_step_with_one_wide_head_runs_the_wide_kernels(dev):
    """One f32 head of 256 (num_heads 1 at d_model 256, mixed_precision
    false): K3f and K3b, every launch on the kernels for heads of 192 and
    wider (csrc/dense_attn_tf32_wide.cu)."""
    start = (denseattn.tf32_wide_fwd.launches, denseattn.tf32_wide_bwd.launches)
    assert _train_step_launches(dev, num_heads=1, d_model=256,
                                mixed_precision=False) == [0, 0, 4, 4, 1, 1, 0, 0]
    assert (denseattn.tf32_wide_fwd.launches - start[0],
            denseattn.tf32_wide_bwd.launches - start[1]) == (4, 4)


def test_f32_train_step_runs_the_narrow_kernels(dev):
    """Two f32 heads of 64 (mixed_precision false): K1 and K2, every launch
    on the f32 kernels for heads of 64 and 128 (csrc/dense_attn_tf32.cu)."""
    start = (denseattn.tf32_narrow_fwd.launches, denseattn.tf32_narrow_bwd.launches)
    assert _train_step_launches(dev, mixed_precision=False) == [4, 4, 0, 0, 1, 1, 0, 0]
    assert (denseattn.tf32_narrow_fwd.launches - start[0],
            denseattn.tf32_narrow_bwd.launches - start[1]) == (4, 4)


def _attn_f64(q, k, v, o, lse, do, scale):
    """O and the gradients of f32 inputs in float64 (qc rounded to f32; the
    backward from the given O and LSE2), [B, N, H, D]."""
    qc = (q * (scale * denseattn.LOG2E)).double()
    k, v, o, do = k.double(), v.double(), o.double(), do.double()
    s = torch.einsum("bqhd,bkhd->bhqk", qc, k)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    o64 = torch.einsum("bhqk,bkhd->bqhd", p, v) / p.sum(-1).permute(0, 2, 1)[..., None]
    p = torch.exp2(s - lse.double()[..., None])
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", do, v)
              - (do * o).sum(-1).permute(0, 2, 1)[..., None])
    return (o64, torch.einsum("bhqk,bkhd->bqhd", ds, k) * scale,
            torch.einsum("bhqk,bqhd->bkhd", ds, qc) * denseattn.LN2,
            torch.einsum("bhqk,bqhd->bkhd", p, do))


@pytest.mark.parametrize("route,b,n,h,d", [
    # the packed route's heads of 64, the BHND route's of 128: N = 192 (the
    # forward's last 128-row block half past N), the decoder's B = 1 at the
    # shipped length (64-row blocks), and B = 4 there (128-row blocks)
    ("packed", 1, 192, 4, 64), ("packed", 1, 2048, 4, 64), ("packed", 4, 2048, 4, 64),
    ("bhnd", 2, 192, 2, 128), ("bhnd", 1, 2048, 2, 128), ("bhnd", 4, 2048, 2, 128),
])
def test_f32_narrow_kernels_match_plain_and_float64(dev, route, b, n, h, d):
    """The f32 kernels for heads of 64 and 128 on either route: O and LSE2
    against the plain version (chip_smoke.py's K1_F32_TOL, K3_F32_O_TOL on
    O at D = 128), the gradients within 1e-5 of max|d| of a float64
    version, O and the gradients no farther from float64 than the plain
    version; every launch on their own counters, the same bits twice."""
    fwd, bwd = ((denseattn.dense_attention_fwd, denseattn.dense_attention_bwd) if route == "packed"
                else (denseattn.dense_attention_bhnd, denseattn.dense_attention_bwd_bhnd))
    gen = torch.Generator(device=dev).manual_seed(n + h + d)
    q, k, v = _packed_views(b, n, h, d, torch.float32, gen, dev)
    do = torch.randn(b, n, h, d, generator=gen, device=dev)
    scale = d ** -0.5
    start = (denseattn.tf32_narrow_fwd.launches, denseattn.tf32_narrow_bwd.launches)
    o, lse = fwd(q, k, v, scale)
    got = bwd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (denseattn.tf32_narrow_fwd.launches - start[0],
            denseattn.tf32_narrow_bwd.launches - start[1]) == (1, 1)
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, scale)
    want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
    f64 = _attn_f64(q, k, v, o, lse, do, scale)
    o_tol = 1e-5 if d == 64 else 3e-5
    assert (o - o_ref).abs().max() <= o_tol * max(1.0, o_ref.abs().max())
    assert (lse - lse_ref).abs().max() <= 1e-5 * max(1.0, lse_ref.abs().max())
    for x, plain, ref in zip((o, *got), (o_ref, *want), f64):
        assert (x.double() - ref).abs().max() <= (plain.double() - ref).abs().max()
    for g, ref in zip(got, f64[1:]):
        assert (g.double() - ref).abs().max() <= 1e-5 * ref.abs().max()
    o2, lse2 = fwd(q, k, v, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)          # no atomics
    again = bwd(q, k, v, o, lse, do, scale)
    assert all(torch.equal(a, g) for a, g in zip(again, got))     # no atomics


def test_bf16_train_step_with_one_wide_head_runs_the_wgmma_wide_kernels(dev):
    """One bf16 head of 256 (num_heads 1 at d_model 256): K3f and K3b,
    every launch on the wgmma kernels for heads of 192 and 256."""
    start = (denseattn.wgmma_wide_fwd.launches, denseattn.wgmma_wide_bwd.launches)
    assert _train_step_launches(dev, num_heads=1, d_model=256) == [0, 0, 4, 4, 1, 1, 0, 0]
    assert (denseattn.wgmma_wide_fwd.launches - start[0],
            denseattn.wgmma_wide_bwd.launches - start[1]) == (4, 4)


def test_bf16_train_step_with_one_wider_head_runs_the_wgmma_wider_kernels(dev):
    """One bf16 head of 512 (num_heads 1 at d_model 512): K3f and K3b,
    every launch on the wgmma kernels for heads of 320 to 512."""
    start = (denseattn.wgmma_wider_fwd.launches, denseattn.wgmma_wider_bwd.launches)
    assert _train_step_launches(dev, num_heads=1, d_model=512) == [0, 0, 4, 4, 1, 1, 0, 0]
    assert (denseattn.wgmma_wider_fwd.launches - start[0],
            denseattn.wgmma_wider_bwd.launches - start[1]) == (4, 4)


def test_bf16_train_step_with_one_head_of_768_runs_the_cluster_kernels(dev):
    """One bf16 head of 768 (num_heads 1 at d_model 768): K3f and K3b,
    every launch on the cluster kernels for heads of 576 to 2048."""
    start = (denseattn.wgmma_cluster_fwd.launches, denseattn.wgmma_cluster_bwd.launches)
    assert _train_step_launches(dev, num_heads=1, d_model=768) == [0, 0, 4, 4, 1, 1, 0, 0]
    assert (denseattn.wgmma_cluster_fwd.launches - start[0],
            denseattn.wgmma_cluster_bwd.launches - start[1]) == (4, 4)


def test_bf16_train_step_with_one_head_of_2304_runs_the_scores_kernels(dev):
    """One bf16 head of 2304 (num_heads 1 at d_model 2304): K3f and K3b,
    every launch on the kernels over written-out scores for heads wider
    than 2048."""
    start = (denseattn.wgmma_scores_fwd.launches, denseattn.wgmma_scores_bwd.launches)
    assert _train_step_launches(dev, num_heads=1, d_model=2304) == [0, 0, 4, 4, 1, 1, 0, 0]
    assert (denseattn.wgmma_scores_fwd.launches - start[0],
            denseattn.wgmma_scores_bwd.launches - start[1]) == (4, 4)


def test_train_step_with_fused_ffn_runs_its_kernels(dev, monkeypatch):
    """VST_FUSED_FFN=1 at ff_dim 128 (rows 8 x 256 = 2048): K6f and K6b
    for the 2 encoder and 2 decoder FFNs."""
    monkeypatch.setenv("VST_FUSED_FFN", "1")
    assert _train_step_launches(dev, ff_dim=128) == [4, 4, 0, 0, 1, 1, 4, 4]


def test_f32_train_step_with_fused_ffn_runs_the_split_tf32_kernels(dev, monkeypatch):
    """The same in f32 (mixed_precision: false): every K6f and K6b launch
    on the split-TF32 kernels, counted on their own counters too."""
    monkeypatch.setenv("VST_FUSED_FFN", "1")
    start = (ffn.tf32_fwd.launches, ffn.tf32_bwd.launches)
    assert _train_step_launches(dev, ff_dim=128, mixed_precision=False) == [4, 4, 0, 0, 1, 1, 4,
                                                                            4]
    assert (ffn.tf32_fwd.launches - start[0], ffn.tf32_bwd.launches - start[1]) == (4, 4)


@pytest.mark.parametrize("env,want", [
    # the plain attention for every shape: no attention kernel
    ({"VST_DISABLE_DENSE_ATTN": "1"}, [0, 0, 0, 0, 1, 1, 0, 0]),
    # the packed shapes on the BHND kernels
    ({"VST_DENSE_ATTN_PACKED": "0"}, [0, 0, 4, 4, 1, 1, 0, 0]),
    # K1 and K2 reading q, k, v as views of the one [d, 3d] product
    ({"VST_FUSED_QKV": "1"}, [4, 4, 0, 0, 1, 1, 0, 0]),
])
def test_train_step_follows_the_attention_switches(dev, monkeypatch, env, want):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    assert _train_step_launches(dev) == want


@pytest.mark.parametrize("b,n,h,d,dtype,strided", [
    (2, 256, 2, 128, torch.bfloat16, True), (2, 256, 2, 128, torch.bfloat16, False),
    (1, 256, 1, 256, torch.bfloat16, True), (2, 128, 1, 256, torch.bfloat16, False),
    (2, 256, 3, 64, torch.bfloat16, True), (1, 128, 3, 64, torch.bfloat16, False),
    (2, 128, 2, 128, torch.float32, True), (1, 128, 1, 256, torch.float32, False),
    (1, 128, 3, 192, torch.bfloat16, True),
    # odd numbers of 64-row tiles, B = 1 at the shipped length, views of
    # one fused [B, N, 3 H D] projection at D = 128
    (2, 192, 2, 128, torch.bfloat16, False), (2, 192, 3, 64, torch.bfloat16, True),
    (1, 2048, 2, 128, torch.bfloat16, True), (3, 320, 1, 128, torch.bfloat16, True),
    # the same with two 64-row warpgroups a forward block (B H N / 128 at
    # least the card's SM count), and B = 1 at an odd head count
    (64, 192, 2, 128, torch.bfloat16, True), (48, 320, 1, 128, torch.bfloat16, False),
    (1, 2048, 3, 64, torch.bfloat16, True),
    # bf16 heads of 320 to 512: the wgmma kernels whose warpgroups split
    # the scores and the head's columns (score panels 3 + 2, 3 + 3, 4 + 3,
    # 4 + 4; dK/dV column groups), an odd number of 64-row tiles included,
    # and B = 1 at the shipped length (the decoder's batch-constant layer
    # of d_model 512, num_heads 1); from 576 to 2048 the cluster kernels
    # (576: 3 CTAs on 3 panels each; 1088: 8 CTAs on 2 or 3), above 2048
    # the kernels over written-out scores (2112: a last 128-column tile
    # half past D; N = 192: the last 128-row tile half past N, on views
    # and on contiguous tensors; two heads of 2304; 4096, no width limit)
    (1, 128, 1, 320, torch.bfloat16, False), (2, 192, 1, 320, torch.bfloat16, True),
    (2, 128, 2, 512, torch.bfloat16, True), (1, 256, 1, 384, torch.bfloat16, False),
    (2, 192, 1, 448, torch.bfloat16, True), (1, 2048, 1, 512, torch.bfloat16, False),
    (2, 192, 1, 576, torch.bfloat16, True), (1, 128, 1, 1088, torch.bfloat16, False),
    (1, 128, 1, 2112, torch.bfloat16, False), (2, 192, 1, 2176, torch.bfloat16, True),
    (3, 192, 1, 2112, torch.bfloat16, False), (1, 256, 2, 2304, torch.bfloat16, True),
    (1, 128, 1, 4096, torch.bfloat16, False),
    (1, 128, 1, 320, torch.float32, True), (1, 192, 2, 512, torch.float32, False),
    # f32 from D = 192 (csrc/dense_attn_tf32_wide.cu, split-TF32 wgmma over
    # written-out scores): a last 128-column tile half past D (192, 448,
    # 576, 1088), three heads, more tiles than the persistent grid's blocks
    # (B H = 272 and 144), and the widths up to 1088
    (1, 128, 3, 192, torch.float32, True), (2, 128, 1, 448, torch.float32, False),
    (136, 128, 2, 192, torch.float32, True), (72, 256, 2, 256, torch.float32, False),
    (2, 192, 1, 576, torch.float32, True), (1, 128, 1, 1088, torch.float32, False),
    # bf16 at D = 192 and 256 (the wgmma kernels whose backward splits the
    # scores between its warpgroups): N = 192, an odd number of 64-row
    # tiles, on views and on contiguous tensors; and two 64-row warpgroups
    # a forward block (B H N / 128 at least the card's SM count)
    (2, 192, 2, 192, torch.bfloat16, True), (3, 192, 1, 256, torch.bfloat16, False),
    (136, 128, 2, 192, torch.bfloat16, False), (72, 256, 1, 256, torch.bfloat16, True),
])
def test_bhnd_kernels_match_plain(dev, b, n, h, d, dtype, strided):
    """K3f and K3b at head widths 64 to 4096 (bf16; f32 to 1088) and an odd
    head count, on views of one packed projection or on contiguous
    tensors, against their plain versions (bounds as chip_smoke.py's:
    bf16 2^-6 of max(1, max|O|) and of max|d|, LSE 1e-3; f32 3e-5 on O,
    1e-5 on the rest, 3e-5 on the gradients above D = 256); both repeat
    bitwise."""
    gen = torch.Generator(device=dev).manual_seed(n + h + d)
    if strided:
        q, k, v = _packed_views(b, n, h, d, dtype, gen, dev)
    else:
        q, k, v = ((torch.randn(b, n, h, d, generator=gen, device=dev) * s).to(dtype)
                   for s in (2.0, 2.0, 1.0))
    do = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
    scale = d ** -0.5
    before = (denseattn.dense_attention_bhnd.launches, denseattn.dense_attention_bwd_bhnd.launches)
    o, lse = denseattn.dense_attention_bhnd(q, k, v, scale)
    got = denseattn.dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale)
    torch.cuda.synchronize()
    assert (denseattn.dense_attention_bhnd.launches,
            denseattn.dense_attention_bwd_bhnd.launches) == (before[0] + 1, before[1] + 1)
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, scale)
    want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
    bf16 = dtype == torch.bfloat16
    o_tol, l_tol, g_tol = (2.0 ** -6, 1e-3, 2.0 ** -6) if bf16 else (3e-5, 1e-5, 1e-5)
    if not bf16 and d > 256:
        g_tol = 3e-5   # chip_smoke.py's K3_F32_WIDE_TOL: sums of D products in other orders
    assert (o.float() - o_ref.float()).abs().max() <= o_tol * max(1.0, o_ref.float().abs().max())
    assert (lse - lse_ref).abs().max() <= l_tol * max(1.0, lse_ref.abs().max())
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == q.shape
        assert (g.float() - w.float()).abs().max() <= g_tol * w.float().abs().max()
    o2, lse2 = denseattn.dense_attention_bhnd(q, k, v, scale)
    assert torch.equal(o2, o) and torch.equal(lse2, lse)          # no atomics
    again = denseattn.dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale)
    assert all(torch.equal(a, g) for a, g in zip(again, got))     # no atomics


def test_head_width_off_the_grid_raises_on_card(dev):
    q = torch.zeros(1, 128, 1, 96, device=dev)
    with pytest.raises(ValueError, match="multiple of 64"):
        denseattn.dense_attention(q, q, q, 0.1)


def _grid(shape, sd, step, gen, dev):
    return (torch.randn(shape, generator=gen, device=dev) * sd / step).round().clamp(-64, 64) * step


# f32 cases on inputs whose products need the split TF32 of the f32
# kernels (dy, W2 and b2 at full f32 mantissa; x, W1 and b1 on the grid, so
# that every side takes the same ReLU mask), held to a float64 version
F32_MIXED = {(4096, 256, 512), (2048, 384, 1536)}


def _ffn_f64(x, dy, w1, b1, w2, b2):
    x, dy, w1, b1, w2, b2 = (t.double() for t in (x, dy, w1, b1, w2, b2))
    h = torch.relu(x @ w1.t() + b1)
    dh = (dy @ w2) * (h > 0)
    return h @ w2.t() + b2 + x, (dh @ w1 + dy, dh.t() @ x, dh.sum(0), dy.t() @ h, dy.sum(0))


@pytest.mark.parametrize("m,d,f,dtype", [
    (4096, 256, 512, torch.bfloat16), (1024, 128, 256, torch.bfloat16),
    (2048, 256, 512, torch.float32), (1024, 128, 128, torch.float32),
    # every width the gate takes: y and dx in 128- or 256-column chunks,
    # x and dy streamed past D = 256
    (2048, 384, 512, torch.bfloat16), (1024, 512, 256, torch.bfloat16),
    (1024, 128, 128, torch.bfloat16), (1024, 2048, 256, torch.bfloat16),
    (1024, 384, 128, torch.float32), (1024, 512, 256, torch.float32),
    # F32_MIXED
    (4096, 256, 512, torch.float32), (2048, 384, 1536, torch.float32),
])
def test_fused_ffn_kernels_match_plain(dev, m, d, f, dtype):
    """K6f and K6b against their plain versions on inputs on the grid of
    chip_smoke.py's K6 bounds (bf16 2^-6, f32 1e-5 of max|ref|), in f32 at
    the shapes of F32_MIXED against a float64 version on inputs that need
    the split, and the backward the same from run to run."""
    gen = torch.Generator(device=dev).manual_seed(m + d + f)
    mixed = dtype == torch.float32 and (m, d, f) in F32_MIXED
    other = ((lambda shape, sd, step: torch.randn(shape, generator=gen, device=dev) * sd)
             if mixed else (lambda shape, sd, step: _grid(shape, sd, step, gen, dev)))
    x, dy = _grid((m, d), 1.0, 1 / 8, gen, dev), other((m, d), 1.0, 1 / 8)
    w1 = _grid((f, d), d ** -0.5, 1 / 256, gen, dev)
    w2 = other((d, f), f ** -0.5, 1 / 256)
    b1, b2 = _grid((f,), 0.05, 1 / 2048, gen, dev), other((d,), 0.05, 1 / 2048)
    x, dy, w1, b1, w2, b2 = (t.to(dtype) for t in (x, dy, w1, b1, w2, b2))
    before = (ffn.fused_ffn_fwd.launches, ffn.fused_ffn_bwd.launches)
    y = ffn.fused_ffn_fwd(x, w1, b1, w2, b2)
    got = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
    torch.cuda.synchronize()
    assert (ffn.fused_ffn_fwd.launches, ffn.fused_ffn_bwd.launches) == (before[0] + 1,
                                                                        before[1] + 1)
    tol = 2.0 ** -6 if dtype == torch.bfloat16 else 1e-5
    if mixed:
        y_ref, want = _ffn_f64(x, dy, w1, b1, w2, b2)
    else:
        y_ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
        want = ffn.fused_ffn_bwd_plain(x, dy, w1, b1, w2)
    assert (y.double() - y_ref.double()).abs().max() <= tol * y_ref.double().abs().max()
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert (g.double() - w.double()).abs().max() <= tol * w.double().abs().max()
    again = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


@pytest.mark.parametrize("b,np_,ng,collapsed", [
    pytest.param(64, 2048, 2048, False, id="64-2048-2048"),
    pytest.param(3, 1000, 77, False, id="3-1000-77"),
    pytest.param(2, 5, 2048, False, id="2-5-2048"),
    # pred on 4 points plus 1e-3 noise: exact and near ties across the
    # kernel's 256-row pred tiles, which 1000 rows do not fill
    pytest.param(8, 2048, 2048, True, id="8-2048-2048-collapsed"),
    pytest.param(8, 1000, 2048, True, id="8-1000-2048-collapsed"),
    pytest.param(4, 300, 1500, False, id="4-300-1500"),
])
def test_chamfer_kernel_matches_plain_bitwise(dev, b, np_, ng, collapsed):
    """K4 in one launch, bitwise equal to its plain version (minima,
    argminima) and from run to run."""
    gen = torch.Generator(device=dev).manual_seed(np_ + ng)
    pred = torch.randn(b, np_, 3, generator=gen, device=dev)
    gt = torch.randn(b, ng, 3, generator=gen, device=dev)
    if collapsed:
        centres = torch.randn(b, 4, 3, generator=gen, device=dev)
        pred = (centres[:, torch.arange(np_, device=dev) % 4]
                + 1e-3 * torch.randn(b, np_, 3, generator=gen, device=dev)).contiguous()
    before = chamfer.chamfer_nn_packed.launches
    got = chamfer.chamfer_nn_packed(pred, gt)
    torch.cuda.synchronize()
    assert chamfer.chamfer_nn_packed.launches == before + 1
    want = chamfer.chamfer_nn_packed_plain(pred, gt)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g.view(torch.int32), w.view(torch.int32))
    again = chamfer.chamfer_nn_packed(pred, gt)
    assert all(torch.equal(a, g) for a, g in zip(again, got))


def test_best_chamfer_takes_kernel_on_card(dev):
    pred = torch.randn(8, 512, 3, device=dev)
    gt = torch.randn(8, 512, 3, device=dev)
    before = chamfer.chamfer_nn_packed.launches
    val = float(chamfer.best_chamfer(pred, gt))
    assert chamfer.chamfer_nn_packed.launches == before + 1
    assert math.isclose(val, float(chamfer.chamfer_distance(pred, gt)), rel_tol=2.0 ** -11)


@pytest.mark.parametrize("b,np_,ng", [(12, 2048, 2048), (8, 2000, 2048), (16, 2048, 4096)])
def test_best_chamfer_outside_the_gate_is_exact_on_card(dev, b, np_, ng):
    """Clouds the JAX gate refuses (B % 8, N % 128, N > 2048) take the
    exact tiled path: no K4 launch, the tiled value bit for bit."""
    gen = torch.Generator(device=dev).manual_seed(b + np_)
    pred = torch.randn(b, np_, 3, generator=gen, device=dev)
    gt = torch.randn(b, ng, 3, generator=gen, device=dev)
    before = chamfer.chamfer_nn_packed.launches
    val = chamfer.best_chamfer(pred, gt)
    assert chamfer.chamfer_nn_packed.launches == before
    assert torch.equal(val, chamfer.chamfer_distance(pred, gt))


# ---------------------------------------------------------------- the FlexibleVAE family


def test_f32_convolutions_run_without_tf32_on_card(dev):
    """PyTorch leaves cuDNN's TF32 on by default (this test does not turn
    it off): the port's f32 Conv and ConvTranspose still compute in f32,
    forward and backward, within 1e-5 of a float64 run on the CPU (TF32
    rounds the operands to 10 mantissa bits, ~1e-3), and leave the
    caller's setting as it was."""
    from vae_song_tpu_torch.nn.blocks import Conv, ConvTranspose

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(3)
    for layer, shape in ((Conv(32, 64, 3, 2, 1, generator=gen), (16, 28, 28, 32)),
                         (ConvTranspose(64, 32, 1, generator=gen), (16, 7, 7, 64))):
        x = torch.randn(*shape, generator=gen)
        want_layer = layer.double()
        xd = x.double().requires_grad_()
        want = want_layer(xd)
        gy = torch.randn(want.shape, generator=gen, dtype=torch.float64)
        want_grads = torch.autograd.grad(want, (xd, want_layer.weight), gy)
        card = layer.float().to(dev)
        xc = x.to(dev).requires_grad_()
        got = card(xc)
        got_grads = torch.autograd.grad(got, (xc, card.weight), gy.float().to(dev))
        assert torch.backends.cudnn.allow_tf32
        for g, w in zip((got, *got_grads), (want, *want_grads)):
            err = float((g.double().cpu() - w).abs().max()) / float(w.abs().max())
            assert err <= 1e-5, (type(layer).__name__, err)


def _flex_step_on(where, kind, dataset, mp, x, eps):
    from vae_song_tpu_torch.models.registry import build_model
    from vae_song_tpu_torch.train.state import make_optimizer
    from vae_song_tpu_torch.train.steps import make_train_step

    model = build_model(kind, dataset, mp, beta=0.01, alpha=0.5,
                        generator=torch.Generator().manual_seed(0)).to(where)
    terms = make_train_step(model, make_optimizer(model.parameters(), lr=1e-2))(
        x.to(where), eps.to(where), 0.5)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.double().cpu() for k, p in model.named_parameters()},
            {k: b.double().cpu() for k, b in model.named_buffers()})


@pytest.mark.parametrize("kind,dataset,mp,shape", [
    ("lrvae", "pinwheel", {"encoder_type": "mlp", "decoder_type": "mlp", "hchans": [16] * 4},
     (256, 2)),
    ("vae", "mnist", {"encoder_type": "conv", "decoder_type": "conv", "hchans": [8, 16, 32]},
     (32, 28, 28, 1)),
])
def test_flexible_f32_train_step_on_card_matches_cpu(dev, kind, dataset, mp, shape):
    """One f32 train step (LR-VAE staged; the conv VAE under PyTorch's
    default cuDNN TF32 setting) on the card and on the CPU from the same
    weights: loss terms within 1e-4 relative, the gradient within 1e-3
    relative L2 (pre-BatchNorm biases left out), the statistics within
    1e-4; no kernel of the port launches."""
    from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases

    torch.backends.cudnn.allow_tf32 = True
    gen = torch.Generator().manual_seed(4)
    x = torch.rand(*shape, generator=gen)
    eps = torch.randn(1, shape[0], 2 if dataset == "pinwheel" else 28, generator=gen)
    start = [f.launches for f in ALL_COUNTERS]
    t_dev, g_dev, b_dev = _flex_step_on(dev, kind, dataset, mp, x, eps)
    assert [f.launches for f in ALL_COUNTERS] == start
    t_cpu, g_cpu, b_cpu = _flex_step_on("cpu", kind, dataset, mp, x, eps)
    assert max(abs(t_dev[k] - t_cpu[k]) / max(abs(t_cpu[k]), 1e-12) for k in t_cpu) <= 1e-4
    keys = [k for k in g_cpu if k not in pre_batchnorm_biases(g_cpu)]
    num = sum(float(((g_dev[k] - g_cpu[k]) ** 2).sum()) for k in keys)
    assert (num / sum(float((g_cpu[k] ** 2).sum()) for k in keys)) ** 0.5 <= 1e-3
    assert all(float((b_dev[k] - b_cpu[k]).abs().max()) <= 1e-4 * max(1.0, float(
        b_cpu[k].abs().max())) for k in b_cpu)


def test_lidvae_decode_and_analysis_on_card_match_cpu(dev):
    """LIDVAE's Brenier decode (small ICNNs) and the cell Lipschitz field on
    the card against the CPU, the same weights and draws: decode within
    1e-5 relative to its largest magnitude, no graph outside training,
    the fields within 1e-4; no kernel of the port launches."""
    from vae_song_tpu_torch import analysis
    from vae_song_tpu_torch.models.lidvae import LIDVAE
    from vae_song_tpu_torch.train.steps import make_apply_fns

    model = LIDVAE.for_dataset("pinwheel", hidden_channels=(16, 2), icnn_channels=(64, 128),
                               inverse_lipschitz=0.2, generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    z = torch.randn(8, 64, 2, generator=gen)
    idx = [torch.randint(0, 64, (8, 500), generator=gen) for _ in range(2)]
    start = [f.launches for f in ALL_COUNTERS]
    cpu = make_apply_fns(model)[1]
    want_dec = cpu(z[0])
    want = analysis.cellwise_decoder_lipschitz(cpu, z, torch.ones(8, dtype=torch.bool),
                                               idx1=idx[0], idx2=idx[1])
    card = make_apply_fns(model.to(dev))[1]
    got_dec = card(z[0].to(dev))
    got = analysis.cellwise_decoder_lipschitz(card, z.to(dev),
                                              torch.ones(8, dtype=torch.bool, device=dev),
                                              idx1=idx[0], idx2=idx[1])
    assert [f.launches for f in ALL_COUNTERS] == start
    assert got_dec.grad_fn is None and not got_dec.requires_grad
    assert float((got_dec.cpu() - want_dec).abs().max()) <= 1e-5 * float(want_dec.abs().max())
    for g, w in zip(got, want):
        assert float((g.cpu() - w).abs().max()) <= 1e-4 * max(1.0, float(w.abs().max()))


def test_lidvae_train_step_on_card_matches_cpu(dev):
    """One LIDVAE f32 train step (second-order through the decode) on the
    card and on the CPU from the same weights: loss terms within 1e-4
    relative, the gradient within 1e-3 relative L2 (pre-BatchNorm biases
    left out), every ICNN weight's gradient nonzero."""
    from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases

    gen = torch.Generator().manual_seed(5)
    x, eps = torch.randn(64, 2, generator=gen), torch.randn(1, 64, 2, generator=gen)
    from vae_song_tpu_torch.models.lidvae import LIDVAE
    from vae_song_tpu_torch.train.state import make_optimizer
    from vae_song_tpu_torch.train.steps import make_train_step

    steps = []
    for where in (dev, "cpu"):
        model = LIDVAE.for_dataset("pinwheel", hidden_channels=(16, 16, 2),
                                   icnn_channels=(32, 64), inverse_lipschitz=0.2, beta=0.1,
                                   generator=torch.Generator().manual_seed(0)).to(where)
        terms = make_train_step(model, make_optimizer(model.parameters(), lr=1e-3))(
            x.to(where), eps.to(where))
        steps.append(({k: float(v) for k, v in terms.items()},
                      {k: p.grad.double().cpu() for k, p in model.named_parameters()}))
    (t_dev, g_dev), (t_cpu, g_cpu) = steps
    assert max(abs(t_dev[k] - t_cpu[k]) / max(abs(t_cpu[k]), 1e-12) for k in t_cpu) <= 1e-4
    keys = [k for k in g_cpu if k not in pre_batchnorm_biases(g_cpu)]
    num = sum(float(((g_dev[k] - g_cpu[k]) ** 2).sum()) for k in keys)
    assert (num / sum(float((g_cpu[k] ** 2).sum()) for k in keys)) ** 0.5 <= 1e-3
    assert all(float(g_dev[k].abs().sum()) > 0 for k in g_dev
               if k.startswith("icnn") and k.endswith("weight"))


def test_remat_train_step_recomputes_the_attention_forward(dev):
    """remat: K1 once more for each self-attention layer's recompute (4
    more a step), K2, K4, K5 as without; with attn_dropout the recompute
    draws the first pass's masks from the CUDA generator (tests/
    test_torch_remat.py holds that on the CPU), and still no K1 / K2."""
    assert _train_step_launches(dev, remat=True) == [8, 4, 0, 0, 1, 1, 0, 0]
    assert _train_step_launches(dev, dropout=True, remat=True,
                                attn_dropout=0.1) == [0, 0, 0, 0, 1, 1, 0, 0]


def test_moe_train_step_runs_the_kernels(dev):
    """moe_experts 4: every FFN a top-1 MoE; the attention and Chamfer
    kernels as on the default route."""
    assert _train_step_launches(dev, moe_experts=4) == [4, 4, 0, 0, 1, 1, 0, 0]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_ffn_on_card_matches_cpu(dev, dtype):
    """The MoE FFN on the card against the CPU on the same tokens and
    weights: every token in the same expert slot (f32; bf16 at least 99%,
    the router's roundings can move a near-tie), the outputs of the tokens
    routed alike to 1e-5 (f32) and 2^-6 (bf16) of max|out|."""
    from vae_song_tpu_torch.nn.moe import MoEFFN
    from vae_song_tpu_torch.parallel import ep

    moe = MoEFFN(64, 128, 4, 1.25, compute_dtype=None if dtype == torch.float32 else dtype,
                 generator=torch.Generator().manual_seed(0))
    x = torch.randn(8, 256, 64, generator=torch.Generator().manual_seed(1))
    outs, slots = [], []
    for where in ("cpu", dev):
        moe.to(where)
        xd = x.to(where)
        with torch.no_grad():
            outs.append(moe(xd).float().cpu().reshape(-1, 64))
            p = moe.params()
            _, slot, keep = ep._dispatch_combine(xd.reshape(-1, 64).to(p.router.dtype), p.router,
                                                 4, ep._capacity(2048, 4, 1.25))
        slots.append(torch.where(keep, slot, -1).cpu())
    alike = slots[0] == slots[1]
    assert float(alike.float().mean()) >= (1.0 if dtype == torch.float32 else 0.99)
    err = float((outs[0][alike] - outs[1][alike]).abs().max())
    assert err <= (1e-5 if dtype == torch.float32 else 2.0 ** -6) * float(outs[0].abs().max())


@pytest.mark.parametrize("m,k,n", [(1024, 256, 512), (64, 128, 256), (8, 256, 3), (17, 20, 5)])
def test_int8_matmul_on_card_is_the_cpu_product(dev, m, k, n):
    """torch._int_mm, padded where its shape rules (M > 16, K and N
    multiples of 8) need it, bitwise equal to the CPU's int32 product."""
    from vae_song_tpu_torch.serving import quant

    gen = torch.Generator().manual_seed(m + k + n)
    a = torch.randint(-127, 128, (m, k), generator=gen, dtype=torch.int8)
    b = torch.randint(-127, 128, (k, n), generator=gen, dtype=torch.int8)
    assert torch.equal(quant.int8_matmul(a.to(dev), b.to(dev)).cpu(), quant.int8_matmul(a, b))


def test_int8_decode_on_card_runs_the_attention_forward(dev):
    """The int8 decode of a SetVAE launches K1 in the decoder's
    self-attentions and lands within the JAX package's 0.05 of the float
    decode."""
    from vae_song_tpu_torch.cli.generate import generate_samples
    from vae_song_tpu_torch.models.registry import build_model

    mp = dict(latent_channel=16, num_points=256, d_model=128, num_heads=2,
              num_encoder_layers=2, num_decoder_layers=2, ff_dim=64, mixed_precision=True)
    model = build_model("setvae", "shapenet", mp, generator=torch.Generator().manual_seed(0))
    model.to(dev)
    before = denseattn.dense_attention_fwd.launches
    q = generate_samples(model, 16, 8, seed=1, quant="int8")
    assert denseattn.dense_attention_fwd.launches - before == 2 * 2
    f = generate_samples(model, 16, 8, seed=1)
    assert float(abs(q - f).max() / abs(f).max()) < 0.05


@pytest.fixture
def nccl_group(dev):
    """A one-rank NCCL process group on the card (a free localhost port),
    closed after the test. One card holds one NCCL rank: the multi-rank
    semantics are held on the CPU with gloo (tests/test_torch_parallel_*.py)."""
    import torch.distributed as dist

    from vae_song_tpu_torch.parallel.mesh import init_multihost

    if dist.is_initialized():
        pytest.skip("a process group is already open")
    saved = {k: os.environ.pop(k, None) for k in ("MASTER_ADDR", "MASTER_PORT")}
    init_multihost("nccl")
    yield
    dist.destroy_process_group()
    for k, v in saved.items():
        if v is not None:
            os.environ[k] = v


@pytest.mark.parametrize("kind", ["dp", "fsdp", "tp", "tp_fsdp"])
def test_one_rank_strategy_steps_run_the_kernels(dev, nccl_group, kind):
    """DistributedDataParallel, FSDP2, the DTensor plan on a 1 x 1 mesh and
    TP x FSDP in a one-rank NCCL group: one train step launches K1, K2, K4
    and K5 as the plain step does (4 layers: 4 K1 and 4 K2) and lands on
    the plain step's loss (1e-5 relative) and gradients (1e-3 relative L2,
    bf16 GEMM outputs cut or ordered elsewhere by the wrappers)."""
    from torch.distributed.device_mesh import init_device_mesh

    from vae_song_tpu_torch.models.registry import build_model
    from vae_song_tpu_torch.nn.sync import full_tensor
    from vae_song_tpu_torch.parallel import fsdp, mesh, tp
    from vae_song_tpu_torch.train.state import TrainState, make_optimizer
    from vae_song_tpu_torch.train.steps import make_train_step

    mp = dict(latent_channel=16, num_points=256, d_model=128, num_heads=2,
              num_encoder_layers=2, num_decoder_layers=2, ff_dim=64, mixed_precision=True)
    mk = lambda: build_model("setvae", "shapenet", mp,  # noqa: E731
                             generator=torch.Generator().manual_seed(0)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(8, 256, 3, generator=gen, device=dev)
    eps = torch.randn(8, 16, generator=gen, device=dev)
    plain = mk()
    want = make_train_step(plain, make_optimizer(plain.parameters(), lr=1e-2))(x, eps, 0.5)
    model = mk()
    state = TrainState(model, make_optimizer(model.parameters(), lr=1e-2))
    if kind == "dp":
        m = mesh.make_mesh()
        step = mesh.make_dp_train_step(model, state.optimizer, m)
    elif kind == "fsdp":
        m = fsdp.make_fsdp_mesh(1)
        state = fsdp.shard_state(state, m)
        step = fsdp.make_fsdp_train_step(model, state.optimizer, m, state.fsdp_params)
    else:
        m = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        if kind == "tp":
            state = tp.shard_state(state, m)
            step = tp.make_tp_dp_train_step(model, state.optimizer, m)
        else:
            state = fsdp.shard_state_tp_fsdp(state, m)
            step = fsdp.make_tp_fsdp_train_step(model, state.optimizer, m, state.fsdp_params)
    start = [f.launches for f in ALL_COUNTERS]
    got = step(x, eps, 0.5)
    torch.cuda.synchronize()
    launches = [f.launches - s for f, s in zip(ALL_COUNTERS, start)]
    assert launches == [4, 4, 0, 0, 1, 1, 0, 0]
    for k in ("loss", "recon", "reg"):
        assert abs(float(got[k]) - float(want[k])) <= 1e-5 * abs(float(want[k])), k
    grads = {k: p.grad.float() for k, p in plain.named_parameters() if p.grad is not None}
    num = sum(float(((full_tensor(p.grad).float() - grads[k]) ** 2).sum())
              for k, p in model.named_parameters() if k in grads and not k.endswith("key.bias"))
    den = sum(float((g ** 2).sum()) for k, g in grads.items() if not k.endswith("key.bias"))
    assert (num / den) ** 0.5 <= 1e-3
