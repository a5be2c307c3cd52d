"""The FlexibleVAE family's building blocks and weight map in the port
against the JAX package on the CPU, with the same weights and BatchNorm
statistics: the UpConv pyramid (Flax's "SAME" transposed convolution,
not torch's padded one), the MLP and conv blocks in train and eval mode,
f32 and bf16, the weight map's round trip for every encoder/decoder
pair, the `.pkl` export into the JAX models, the rule table's one rule a
key, and the Dense / Conv biases a BatchNorm follows. The models'
forward passes have tests/test_torch_flexible.py.

JAX runs eagerly here (no jit), so every op rounds as Flax declares it,
which is what the port copies. Every bound sits beside the difference it
was set from.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import flax.linen as fnn
from vae_song_tpu.models import flexible as jax_flexible
from vae_song_tpu.nn import blocks as jax_blocks
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train.loop import init_model
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models import flexible
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.models.setvae import SetVAE
from vae_song_tpu_torch.nn import blocks
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.train import checkpoint

from jax_parity import (FLEX_ARCHS, flex_inputs, flex_pair, max_rel, random_stats, rel_err,
                        to_np)

B = 16
OUT_NAMES = ("recon", "mu", "logvar", "z", "z_recon")


# ---------------------------------------------------------------- UpConv


class _JaxPyramid(fnn.Module):
    """The conv decoder's up-sampling: UpConv per output padding."""

    pads: tuple
    dtype: object = None

    @fnn.compact
    def __call__(self, x):
        for pad in self.pads:
            x = jax_flexible.UpConv(8, pad, dtype=self.dtype)(x)
        return x


# The MNIST pyramid 4 -> 7 -> 14 -> 28 (transpose_padding_schedule(28, 3)).
# f32: the same products summed in another order, measured 3.0e-8
# relative; bound 1e-5. bf16: each step rounds its output to bf16 on both
# sides, measured 0; bound 2^-7 relative (one ulp at every step). The
# shifted torch layer is 0.19 away.
@pytest.mark.parametrize("dtype,tol", [(None, 1e-5), (torch.bfloat16, 2.0 ** -7)])
def test_upconv_pyramid_matches_flax(dtype, tol):
    fc, pads = flexible.transpose_padding_schedule(28, 3)
    x = np.random.default_rng(0).normal(size=(2, fc, fc, 8)).astype(np.float32)
    jm = _JaxPyramid(tuple(pads), jnp.bfloat16 if dtype else None)
    params = to_np(jm.init(jax.random.PRNGKey(0), x)["params"])
    want = np.asarray(jm.apply({"params": params}, x).astype(jnp.float32))
    steps = [blocks.ConvTranspose(8, 8, p, dtype) for p in pads]
    for i, step in enumerate(steps):
        sd = weights.params_to_state_dict({"decoder": {"UpConv_0": params[f"UpConv_{i}"]}},
                                          ["decoder.up.0.conv.weight", "decoder.up.0.conv.bias"])
        step.weight.data, step.bias.data = sd["decoder.up.0.conv.weight"], sd["decoder.up.0.conv.bias"]
    got = torch.from_numpy(x)
    for step in steps:
        got = step(got)
    assert tuple(got.shape) == want.shape == (2, 28, 28, 8)
    assert rel_err(got, want) <= tol
    # torch's ConvTranspose2d(padding=1, output_padding=p) is the same image
    # shifted by one pixel: far from Flax's
    if dtype is None:
        shifted = torch.from_numpy(x)
        for step in steps:
            shifted = F.conv_transpose2d(
                shifted.permute(0, 3, 1, 2), step.weight, step.bias, 2, 1,
                step.output_padding).permute(0, 2, 3, 1)
        assert shifted.shape == got.shape and rel_err(shifted, want) > 0.1


# ---------------------------------------------------------------- blocks


class _JaxBlock(fnn.Module):
    """One JAX block, so its tree nests under a `<Name>_0` key as in a model."""

    make: object

    @fnn.compact
    def __call__(self, x, train):
        return self.make()(x, train)


_BLOCKS = {
    "MLPBlock": (lambda dt: jax_blocks.MLPBlock(8, dtype=dt),
                 lambda dt: blocks.MLPBlock(6, 8, dt), (B, 6), "mlp.0"),
    "ResidualMLPBlock": (lambda dt: jax_blocks.ResidualMLPBlock(8, dtype=dt),
                         lambda dt: blocks.ResidualMLPBlock(6, 8, dt), (B, 6), "res_mlp.0"),
    "ResidualMLPBlock same width": (lambda dt: jax_blocks.ResidualMLPBlock(6, dtype=dt),
                                    lambda dt: blocks.ResidualMLPBlock(6, 6, dt), (B, 6),
                                    "res_mlp.0"),
    "ResidualConvBlock stride 2": (lambda dt: jax_blocks.ResidualConvBlock(8, 2, dtype=dt),
                                   lambda dt: blocks.ResidualConvBlock(3, 8, 2, dt),
                                   (4, 9, 9, 3), "res_conv.0"),
    "ResidualConvBlock stride 1": (lambda dt: jax_blocks.ResidualConvBlock(3, 1, dtype=dt),
                                   lambda dt: blocks.ResidualConvBlock(3, 3, 1, dt),
                                   (4, 9, 9, 3), "res_conv.0"),
    # no model holds one: it takes the conv block's path (its leaves are a
    # subset of that block's)
    "PlainConvolution": (lambda dt: jax_blocks.PlainConvolution(8, 2, dtype=dt),
                         lambda dt: blocks.PlainConvolution(3, 8, 2, dt), (4, 9, 9, 3),
                         "res_conv.0"),
}


class _Holder(torch.nn.Module):
    """A port block at the module path the weight map knows."""

    def __init__(self, path, block):
        super().__init__()
        group = path.split(".")[0]
        setattr(self, group, torch.nn.ModuleList([block]))
        self.block = lambda x: getattr(self, group)[0](x)

    def forward(self, x):
        return self.block(x)


# Train and eval mode, relative to max(1, max|want|), f32 and bf16: the
# same roundings, the f32 statistics summed in another order: measured up
# to 2.8e-7 on the output and 1.9e-7 on the running statistics (with these
# inputs no bf16 convolution output lands on the other side of a rounding
# boundary; in the models some do, FORWARD bounds below); bound 1e-5.
@pytest.mark.parametrize("mixed", [False, True])
@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("name", list(_BLOCKS))
def test_blocks_match_flax(name, train, mixed):
    make_jax, make_port, shape, path = _BLOCKS[name]
    dt = jnp.bfloat16 if mixed else None
    x = (np.random.default_rng(1).normal(size=shape) * 2 + 0.5).astype(np.float32)
    jm = _JaxBlock(lambda: make_jax(dt))
    variables = to_np(jm.init(jax.random.PRNGKey(0), x, True))
    bs = random_stats(variables["batch_stats"], 2)
    want, new = jm.apply({"params": variables["params"], "batch_stats": bs}, x, train,
                         mutable=["batch_stats"])
    port = _Holder(path, make_port(torch.bfloat16 if mixed else None))
    group = path.split(".")[0]
    flax_name = {"mlp": "MLPBlock_0", "res_mlp": "ResidualMLPBlock_0",
                 "res_conv": "ResidualConvBlock_0"}[group]
    tree = lambda t: {"encoder": {flax_name: t[next(iter(t))]}}
    sd = weights.params_to_state_dict(tree(variables["params"]),
                                      ["encoder." + k for k in port.state_dict()], tree(bs))
    port.load_state_dict({k[len("encoder."):]: v for k, v in sd.items()})
    got = port.train(train)(torch.from_numpy(x))
    assert got.dtype == torch.float32
    assert rel_err(got, want) <= 1e-5
    got_bs = weights.state_dict_to_variables(
        {"encoder." + k: v for k, v in port.state_dict().items()})["batch_stats"]
    assert max_rel(got_bs["encoder"][flax_name], new["batch_stats"][next(iter(bs))]) <= 1e-5


# ---------------------------------------------------------------- the weight map


@pytest.mark.parametrize("arch", list(FLEX_ARCHS))
def test_weight_map_round_trip_every_family(arch):
    """JAX variables -> port -> JAX variables bit for bit, the statistics
    with the params, for each encoder/decoder pair; the Flax tree's every
    leaf has a port counterpart and each port key one rule."""
    _, params, bs, port = flex_pair("lrvae", arch, extra={})
    back = weights.state_dict_to_variables(port.state_dict())
    for got, want in ((back["params"], params), (back["batch_stats"], bs)):
        a = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        b = dict(jax.tree_util.tree_flatten_with_path(want)[0])
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    with pytest.raises(RuntimeError):
        weights.load_flax_params(port, params)          # statistics missing


# Eval mode, f32: the forward of the reloaded JAX model against the port's,
# measured up to 7.4e-7 relative; bound 1e-5.
@pytest.mark.parametrize("kind,arch", [("vae", "mlp2d"), ("lrvae", "conv-conv"),
                                       ("nae", "conv-mlp")])
def test_params_export_loads_into_jax(tmp_path, kind, arch):
    """A `model_{epoch}.pkl` the port writes (after a train-mode forward
    moved its statistics) loads into the JAX model, statistics included,
    and gives the port's eval forward."""
    jmodel, _, _, port = flex_pair(kind, arch, seed=3)
    x = torch.from_numpy(flex_inputs(arch, B, seed=4))
    with torch.no_grad():
        port.train()(x)
    path = str(tmp_path / "model_0.pkl")
    checkpoint.save_params_only(path, port)
    template = jax.eval_shape(lambda a: init_model(jmodel, a), flex_inputs(arch, 2))
    params, bs = jax_ckpt.load_params_only(path, template[0], template[1])
    want = jmodel.apply({"params": params, "batch_stats": bs}, jnp.asarray(x.numpy()),
                        latent_rand_sampling=False, train=False)
    with torch.no_grad():
        got = port.eval()(x)
    for name, g, w in zip(OUT_NAMES, got, want):
        assert rel_err(g, w) <= 1e-5, name


def test_every_port_key_matches_one_rule(monkeypatch):
    """The DeepSets and the flexible rules share `encoder.` / `decoder.`
    prefixes: no key of any family the port builds matches two rules."""
    models = [build_model(kind, FLEX_ARCHS[a][0], FLEX_ARCHS[a][1])
              for kind in ("vae", "lrvae") for a in FLEX_ARCHS]
    models += [SetVAE(latent_channel=8, num_points=16, d_model=64, num_heads=1, ff_dim=64,
                      use_attention=u, encoder_hidden=(8,), decoder_hidden=(8,))
               for u in (True, False)]
    seen = {}
    for m in models:
        for k in m.state_dict():
            seen[k] = weights.flax_path(k)
    assert len(seen) > 100
    # a second rule for a key is refused
    monkeypatch.setattr(weights, "_RULES", weights._RULES + [
        (r"(encoder|decoder)\.mlp\.(\d+)\.dense", "x/y", "dense")])
    with pytest.raises(KeyError, match="rules"):
        weights.flax_path("encoder.mlp.0.dense.weight")


# ---------------------------------------------------------------- pre-BatchNorm biases


@pytest.mark.parametrize("arch", list(FLEX_ARCHS))
def test_pre_batchnorm_biases_have_no_gradient(arch):
    """`pre_batchnorm_biases` finds every Dense / Conv bias a BatchNorm
    follows: in train mode their gradient is roundoff (<= 1e-4 of the
    largest), every other bias gets a real one."""
    _, _, _, port = flex_pair("vae", arch)
    x = torch.from_numpy(flex_inputs(arch, B))
    outs = port.train()(x, torch.randn(1, B, port.latent_channel))
    total = port.loss(x, *outs)[0]
    names = [k for k, _ in port.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(total, list(port.parameters()))))
    pre = pre_batchnorm_biases(port.state_dict().keys())
    scale = max(float(g.abs().max()) for g in grads.values())
    biases = [k for k in names if k.endswith(".bias") and ".norm" not in k]
    assert pre and pre <= set(biases)
    for k in biases:
        small = float(grads[k].abs().max()) <= 1e-4 * scale
        assert small == (k in pre), (k, float(grads[k].abs().max()), scale)
