"""The port's SetVAE / SetLRVAE inference path against the JAX package
on the CPU, with the same weights (through vae_song_tpu_torch.weights)
and the same numpy inputs, noise and latents.

The JAX side runs as its own tests run it on the CPU: MultiHeadAttention
takes `_xla_attention`, which rounds q, k, v and P to bf16 even in an
f32 model (vae_song_tpu/ops/attention.py:124-139), while the port takes
its dense attention (the plain version of the kernel) at the same
shapes. One f32 case patches the JAX gate so that JAX runs its packed
Pallas kernel in interpret mode instead; that case is held tightly.
"""

import functools
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.ops import attention as jax_attention
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train.loop import init_model
from vae_song_tpu.train.state import TrainState, make_optimizer
from vae_song_tpu.train.steps import make_apply_fns as jax_apply_fns
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.cli import generate as torch_generate
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.ops.attention import MultiHeadAttention
from vae_song_tpu_torch.train.checkpoint import load_params_only
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step

B, N, LATENT = 4, 128, 16
MODEL_PARAMS = dict(latent_channel=LATENT, num_points=N, d_model=128, num_heads=2,
                    num_encoder_layers=2, num_decoder_layers=2, ff_dim=64)
BETA, ALPHA, WU_ALPHA = 0.001, 0.5, 0.3

# Tolerances, JAX (its CPU path) vs port, with the measured max diffs:
# f32, JAX attention rounding to bf16: loss terms 4.1e-5 relative,
# recon and decode 2.3e-4 absolute (|recon| <= 1.8).
F32_LOSS_RTOL, F32_RECON_ATOL = 5e-4, 2e-3
# f32 with JAX on its packed kernel (interpret mode): 1.0e-7 relative,
# 8.3e-7 absolute -- summation order only.
KERNEL_F32_LOSS_RTOL, KERNEL_F32_RECON_ATOL = 2e-6, 1e-5
# mixed precision: bf16 GEMM outputs, LayerNorm outputs and attention
# roundings at different points, 4 post-norm layers each way: 1.2e-3
# relative on the loss terms, 0.0155 absolute on recon.
BF16_LOSS_RTOL, BF16_RECON_ATOL = 1e-2, 6e-2


def _jax_model_and_state(kind, mixed, seed=0):
    mp = dict(MODEL_PARAMS, mixed_precision=mixed)
    model = jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    params, bstats = init_model(model, np.zeros((2, N, 3), np.float32), seed=seed)
    state = TrainState.create(params, bstats, make_optimizer(lr=0.0))
    return model, params, state


def _port_model(kind, mixed, params):
    mp = dict(MODEL_PARAMS, mixed_precision=mixed)
    model = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    return weights.load_flax_params(model, params)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, N, 3)).astype(np.float32)
    eps = rng.normal(size=(B, LATENT)).astype(np.float32)
    z = rng.normal(size=(B, LATENT)).astype(np.float32)
    return x, eps, z


def _jax_eval(model, state, x, eps):
    """The JAX eval step with explicit eps: encode -> reparameterise ->
    decode (-> re-encode for SetLRVAE) -> model.loss."""
    encode, decode, _ = jax_apply_fns(model)
    x = jnp.asarray(x)
    mu, log_var = encode(state, x)
    z = mu + jnp.asarray(eps) * jnp.exp(0.5 * log_var)
    recon = decode(state, z)
    z_recon = encode(state, recon)[0] if hasattr(model, "alpha") else None
    total, rec, reg, lr = model.loss(x, recon, mu, log_var, z, z_recon, wu_alpha=WU_ALPHA)
    return {"loss": total, "recon": rec, "reg": reg, "lr": lr}, np.asarray(recon)


def _compare(kind, mixed, loss_rtol, recon_atol):
    model, params, state = _jax_model_and_state(kind, mixed)
    port = _port_model(kind, mixed, params)
    x, eps, z = _data()
    want, want_recon = _jax_eval(model, state, x, eps)
    got = make_eval_step(port)(torch.from_numpy(x), torch.from_numpy(eps), WU_ALPHA)
    for name in ("loss", "recon", "reg", "lr"):
        w, g = float(want[name]), float(got[name])
        assert np.isfinite(g), name
        assert abs(g - w) <= loss_rtol * max(abs(w), 1e-6), (name, w, g)
    _, decode, forward = make_apply_fns(port)
    recon = forward(torch.from_numpy(x), torch.from_numpy(eps))[0]
    assert recon.dtype == torch.float32 and recon.shape == (B, N, 3)
    np.testing.assert_allclose(recon.numpy(), want_recon, atol=recon_atol, rtol=0)
    # generation decodes z ~ N(0, I): same z on both sides
    _, jax_decode, _ = jax_apply_fns(model)
    np.testing.assert_allclose(decode(torch.from_numpy(z)).numpy(),
                               np.asarray(jax_decode(state, jnp.asarray(z))),
                               atol=recon_atol, rtol=0)


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_eval_and_decode_match_jax_f32(kind):
    _compare(kind, False, F32_LOSS_RTOL, F32_RECON_ATOL)


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_eval_and_decode_match_jax_mixed_precision(kind):
    _compare(kind, True, BF16_LOSS_RTOL, BF16_RECON_ATOL)


def test_eval_matches_jax_running_its_attention_kernel(monkeypatch):
    """JAX's MultiHeadAttention routes through its packed Pallas kernel
    (interpret mode) when its gate is patched open, as
    tests/test_denseattn_packed.py:155 patches the gate."""
    monkeypatch.setattr(
        jax_attention, "_packed_attn_ok",
        lambda n_q, n_kv, h, d: jax_denseattn.packed_ok(n_q, n_kv, h, d),
    )
    monkeypatch.setattr(
        jax_denseattn, "dense_attention_packed",
        functools.partial(jax_denseattn.dense_attention_packed, interpret=True),
    )
    _compare("setvae", False, KERNEL_F32_LOSS_RTOL, KERNEL_F32_RECON_ATOL)


def _jax_mha(n_q, n_kv, d_model, heads, seed):
    rng = np.random.default_rng(seed)
    xq = rng.normal(size=(2, n_q, d_model)).astype(np.float32)
    xkv = xq if n_q == n_kv else rng.normal(size=(2, n_kv, d_model)).astype(np.float32)
    mha = jax_attention.MultiHeadAttention(num_heads=heads, d_model=d_model)
    params = mha.init(jax.random.PRNGKey(seed), xq, xkv)["params"]
    want = np.asarray(mha.apply({"params": params}, xq, xkv))
    port = MultiHeadAttention(d_model, heads)
    sd = {f"{proj}.{leaf}": torch.tensor(
              np.asarray(params[proj]["kernel" if leaf == "weight" else "bias"]).T
              if leaf == "weight" else np.asarray(params[proj]["bias"]))
          for proj in ("query", "key", "value", "out") for leaf in ("weight", "bias")}
    port.load_state_dict(sd)
    with torch.inference_mode():
        got = port(torch.from_numpy(xq), torch.from_numpy(xkv)).numpy()
    return got, want


@pytest.mark.parametrize("n_q,n_kv,heads,atol", [
    # kernel-eligible self-attention: port exact f32, JAX rounds q/k/v/P
    # to bf16 (measured 5.3e-4 at |out| <= 0.17)
    (128, 128, 2, 3e-3),
    # not kernel-eligible (N % 128 != 0): both sides bf16-rounded plain
    # attention, bf16 rounding flips of P (measured 6.4e-6)
    (100, 100, 2, 5e-5),
    # kv length 1 (decoder cross-attention): value + out projections only
    # (measured 4.8e-7)
    (128, 1, 2, 5e-6),
])
def test_mha_matches_jax(n_q, n_kv, heads, atol):
    got, want = _jax_mha(n_q, n_kv, 128, heads, seed=n_q + n_kv)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_weights_round_trip_identical():
    _, params, _ = _jax_model_and_state("setvae", True)
    port = _port_model("setvae", True, params)
    back = weights.state_dict_to_params(port.state_dict())
    flat = lambda t: dict(jax.tree_util.tree_flatten_with_path(t)[0])
    a, b = flat(params), flat(back)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k], err_msg=str(k))


def test_weights_refuse_unknown_leaves():
    _, params, _ = _jax_model_and_state("setvae", False)
    port = build_model("setvae", "shapenet", MODEL_PARAMS)
    extra = dict(params, extra={"kernel": np.zeros((1, 1), np.float32)})
    with pytest.raises(KeyError):
        weights.load_flax_params(port, extra)
    with pytest.raises(KeyError):
        weights.flax_path("encoder.unknown.weight")


def test_jax_checkpoint_generates_same_clouds(tmp_path):
    """A JAX `save_params_only` export, read by the port's generation
    CLI, decodes the clouds the JAX model decodes from the same z."""
    model, params, state = _jax_model_and_state("setvae", False, seed=1)
    ckpt = tmp_path / "params" / "model_4.pkl"
    jax_ckpt.save_params_only(str(ckpt), params, state.batch_stats)
    config = {"experiment_type": "setvae", "common_params": {"exp_data": "shapenet"},
              "model_params": dict(MODEL_PARAMS, beta_list=[BETA])}
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text(yaml.safe_dump(config))

    out_dir = torch_generate.main(["--config", str(cfg), "--param_dir", str(ckpt),
                                   "--n_samples", "3", "--batch_size", "2",
                                   "--seed", "5", "--device", "cpu"])
    got = np.stack([np.load(os.path.join(out_dir, f"sample_{i:04d}.npy")) for i in range(3)])
    assert os.path.exists(os.path.join(out_dir, "sample_0002.ply"))

    gen = torch.Generator().manual_seed(5)
    z = torch.cat([torch.randn(2, LATENT, generator=gen) for _ in range(2)])[:3].numpy()
    _, jax_decode, _ = jax_apply_fns(model)
    want = np.asarray(jax_decode(state, jnp.asarray(z)))
    np.testing.assert_allclose(got, want, atol=F32_RECON_ATOL, rtol=0)

    # the loader alone: same parameters as the JAX tree
    port = load_params_only(str(ckpt), build_model("setvae", "shapenet", MODEL_PARAMS))
    with open(ckpt, "rb") as f:
        payload = pickle.load(f)
    np.testing.assert_array_equal(
        port.decoder.query_embed.detach().numpy(), payload["params"]["decoder"]["query_embed"])


def test_generate_samples_shape_and_seed():
    port = build_model("setvae", "shapenet", MODEL_PARAMS,
                       generator=torch.Generator().manual_seed(0))
    a = torch_generate.generate_samples(port, 5, batch_size=2, seed=3)
    b = torch_generate.generate_samples(port, 5, batch_size=2, seed=3)
    assert a.shape == (5, N, 3) and a.dtype == np.float32 and np.isfinite(a).all()
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("exp_type", ["lidvae"])
def test_unported_families_name_their_roadmap_item(exp_type):
    """LIDVAE, the last family the registry refused, now builds with JAX's
    defaults for the dataset (MNIST: latent 32, the conv encoder, ICNNs of
    512 and 1024) and the same parameter tree; so do the MoE layers, the
    last option the registry refused (`moe_experts`, ROADMAP.md Queue 1
    item 15's single-device half)."""
    port = build_model(exp_type, "mnist", {})
    jmodel = jax_build_model(exp_type, "mnist", {})
    variables = jax.eval_shape(lambda x: init_model(jmodel, x),
                               np.zeros((2, 28, 28, 1), np.float32))
    want = jax.tree_util.tree_flatten_with_path(variables[0])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        weights.state_dict_to_variables(port.state_dict())["params"])[0])
    assert {k: tuple(v.shape) for k, v in want} == {k: v.shape for k, v in got.items()}
    mp = {"moe_experts": 4, "num_points": 64}
    variables = jax.eval_shape(lambda x: init_model(jax_build_model("setvae", "shapenet", mp), x),
                               np.zeros((2, 64, 3), np.float32))
    want = jax.tree_util.tree_flatten_with_path(variables[0])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(weights.state_dict_to_variables(
        build_model("setvae", "shapenet", mp).state_dict())["params"])[0])
    assert {k: tuple(v.shape) for k, v in want} == {k: v.shape for k, v in got.items()}


@pytest.mark.parametrize("exp_type", ["vae", "nae", "lrvae"])
def test_flexible_families_build_with_jax_defaults(exp_type):
    """With no model_params the registry builds JAX's defaults: the
    dataset's architecture (MNIST: 1 channel, 28 x 28, latent 28, hidden
    32-64-128), a conv encoder and an MLP decoder, f32; the same
    parameter count and shapes as the JAX model's tree."""
    port = build_model(exp_type, "mnist", {}, beta=0.5, alpha=0.1)
    jmodel = jax_build_model(exp_type, "mnist", {}, beta=0.5, alpha=0.1)
    for attr in ("in_channel", "latent_channel", "hidden_channels", "input_dim",
                 "encoder_type", "decoder_type", "mixed_precision", "beta", "grad_mode"):
        assert getattr(port, attr) == getattr(jmodel, attr), attr
    assert (port.encoder_type, port.decoder_type, port.grad_mode) == (
        "conv", "mlp", "staged" if exp_type == "lrvae" else "composite")
    variables = jax.eval_shape(lambda x: init_model(jmodel, x),
                               np.zeros((2, 28, 28, 1), np.float32))
    want = jax.tree_util.tree_flatten_with_path(variables[0])[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        weights.state_dict_to_variables(port.state_dict())["params"])[0])
    assert {k: tuple(v.shape) for k, v in want} == {k: v.shape for k, v in got.items()}
    assert sum(p.numel() for p in port.parameters()) == sum(int(np.prod(v.shape))
                                                            for _, v in want)


def test_warmup_is_declared_by_the_model():
    """train_and_test runs the wu_alpha warmup for the models that declare
    `has_warmup` (JAX: the LR* class names, loop.py:779), whatever a
    subclass is called."""
    from vae_song_tpu_torch.models import flexible, setvae

    warm = {cls.__name__ for cls in (flexible.NaiveAE, flexible.VanillaVAE, flexible.LRVAE,
                                     setvae.SetVAE, setvae.SetLRVAE)
            if getattr(cls, "has_warmup", False)}
    assert warm == {"LRVAE", "SetLRVAE"}


def test_seeded_init_follows_reference_bounds():
    """Same seed, same weights; init bounds as the JAX initializers
    (torch Linear default, MHA in-projection sqrt(1.5/fan_in), zero
    in-projection bias, query_embed N(0, 0.02^2))."""
    mk = lambda: build_model("setvae", "shapenet", MODEL_PARAMS,
                             generator=torch.Generator().manual_seed(7))
    a, b = mk(), mk()
    for (k, v), w in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(v, w, atol=0, rtol=0, msg=k)
    attn = a.encoder.layers[0].self_attn
    d = MODEL_PARAMS["d_model"]
    assert attn.query.weight.abs().max() <= np.sqrt(1.5 / d)
    assert attn.query.bias.abs().max() == 0 and attn.out.bias.abs().max() == 0
    assert a.encoder.layers[0].ff_up.weight.abs().max() <= 1 / np.sqrt(d)
    assert 0.01 < float(a.decoder.query_embed.detach().std()) < 0.03


@pytest.mark.parametrize("ext", ["npy", "npz", "txt"])
def test_shapenet_helpers_match_jax(tmp_path, ext):
    """The port's numpy copies of fake_point_clouds, load_points and
    resample give the JAX package's results."""
    from vae_song_tpu.data import shapenet as jax_shapenet
    from vae_song_tpu_torch.data import shapenet

    got, _ = shapenet.fake_point_clouds(3, 50, seed=4)
    want, _ = jax_shapenet.fake_point_clouds(3, 50, seed=4)
    np.testing.assert_array_equal(got, want)

    path = str(tmp_path / f"cloud.{ext}")
    if ext == "npy":
        np.save(path, got[0])
    elif ext == "npz":
        np.savez(path, pc=got[0])
    else:
        np.savetxt(path, got[0])
    pts = shapenet.load_points(path)
    np.testing.assert_array_equal(pts, jax_shapenet.load_points(path))
    for n in (20, 50, 80):
        np.testing.assert_array_equal(
            shapenet.resample(pts, n, np.random.default_rng(1)),
            jax_shapenet.resample(pts, n, np.random.default_rng(1)))
