"""Tensor parallelism (parallel/tp.py: DTensor) on two gloo ranks on the
CPU: the plan's structural rule, its coverage invariant and the square
FFN's pairing (JAX tests/test_tp.py:24,54,82,105); the TP step on a 1 x 2
mesh against the single-device step (test_tp.py:128) with two local heads
of 64 (the packed route), with one (the BHND route, where the single
device takes the packed one) and with the fused FFN; the trainer's
tensor_parallel path against the single-device trainer
(test_trainer_tp_sp.py:47); the plan against JAX's and each step against
JAX make_tp_dp_train_step on conftest's virtual devices; the first rank's
state taken by every rank. TP x DP and TP x FSDP, whose 2 x 2 mesh needs
four ranks, are tests/test_torch_parallel_tp_fsdp.py, with this file's
helpers.

One process group of two ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import os
import types

import numpy as np
import pytest
import torch
from torch import nn

from vae_song_tpu.parallel import merge_tp_fsdp_specs as jax_merge_tp_fsdp_specs
from vae_song_tpu.parallel import tp as jax_tp
from jax_parity import jax_sharded_step, jax_spec_at, port_spec_as_flax, sharded_jax_gaps
from torch_parallel_worker import _model, start_ranks, wait_ranks
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.nn.blocks import Dense
from vae_song_tpu_torch.parallel.fsdp import merge_tp_fsdp_specs
from vae_song_tpu_torch.parallel.tp import (check_flash_partitionable, check_tp_coverage,
                                            setvae_param_specs)
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

WORLD, LR, WU = 2, 1e-2, 0.5
COL, ROW = ("model", None), (None, "model")
TINY = dict(exp_type="setlrvae", dataset="shapenet", beta=0.1, alpha=0.1, seed=5,
            model_params=dict(latent_channel=8, num_points=32, d_model=16, num_heads=2,
                              ff_dim=32))
# four heads of 64 at N = 128: dense_ok shapes, packed_ok at an even
# local head count; ff_dim < d_model
WIDE = dict(exp_type="setlrvae", dataset="shapenet", beta=0.1, alpha=0.1, seed=6,
            model_params=dict(latent_channel=8, num_points=128, d_model=256, num_heads=4,
                              ff_dim=128, num_encoder_layers=1, num_decoder_layers=1))
# two heads of 64: one a rank at t = 2
NARROW = dict(WIDE, model_params=dict(WIDE["model_params"], d_model=128, num_heads=2))
TRAINER_MODEL = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=7,
                     model_params=dict(latent_channel=8, num_points=32, d_model=32,
                                       num_heads=4, ff_dim=32, num_encoder_layers=2,
                                       num_decoder_layers=1))
TRAIN = dict(epochs=2, batch_size=8, dataset_name="shapenet", resultname="res_tp",
             dataset_params={"fake": True, "num_samples": 32, "num_points": 32,
                             "num_test_samples": 8},
             visualize_artifacts=False, progress=False, seed=0, lr=1e-3)


def _inputs(spec, b, seed):
    rng = np.random.default_rng(seed)
    mp = spec["model_params"]
    return (rng.normal(size=(b, mp["num_points"], 3)).astype(np.float32),
            rng.normal(size=(b, mp["latent_channel"])).astype(np.float32))


def _step(name, spec, strategy, mesh, b, seed, **kw):
    x, eps = _inputs(spec, b, seed)
    return dict(spec, fn="sharded", name=name, strategy=strategy, mesh=mesh, x=x, eps=eps,
                wu=WU, lr=LR, **kw)


# B = 8 at N = 128: 1024 rows, the fused FFN's gate
STEPS = {
    "tp": _step("tp", WIDE, "tp_dp", [1, 2], 4, 0),
    "tp_one_head": _step("tp_one_head", NARROW, "tp_dp", [1, 2], 4, 1),
    "tp_fused_ffn": _step("tp_fused_ffn", WIDE, "tp_dp", [1, 2], 8, 3,
                          env={"VST_FUSED_FFN": "1"}),
}


def run_file(tmp_path_factory, name, world, steps, trainers, epochs=TRAIN["epochs"],
             extra=()):
    """`steps`, the trainer phases {phase name: train_and_test kwargs} and
    the `extra` phases on `world` ranks; the single-device trainer run
    (`epochs` epochs, as the trainer phases), the single-device steps and
    JAX's steps of the same strategies they are held to."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp(name)
    train = dict(TRAIN, epochs=epochs)
    phases = [*steps.values(),
              *(dict(TRAINER_MODEL, fn="trainer", name=n,
                     kwargs=dict(train, output_root=str(tmp / n), **kw))
                for n, kw in trainers.items()), *extra]
    ranks = start_ranks({"phases": phases}, world, tmp)
    # the references while the ranks run
    single_state, single = train_and_test(_model(TRAINER_MODEL), device="cpu",
                                          output_root=str(tmp / "single"), **train)
    refs = {n: _single_step(phase) for n, phase in steps.items()}
    jax_refs = {n: jax_sharded_step(phase, _model(phase)) for n, phase in steps.items()}
    outs = wait_ranks(ranks)
    torch.set_num_threads(threads)
    return dict(outs=outs, tmp=tmp, single=single, single_state=single_state, refs=refs,
                jax_refs=jax_refs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # one epoch, 4 steps (JAX test_trainer_tp_sp.py:47 takes 4): over a
    # second one a bf16 rounding of the attention that lands the other way
    # on one side grows the eval loss's gap from 1.3e-6 to 5.2e-4
    yield run_file(tmp_path_factory, "tp", WORLD, STEPS, {"train_tp": {"tensor_parallel": 2}},
                   epochs=1, extra=[dict(TINY, fn="replicated", name="replicated",
                                         strategy="tp_dp", mesh=[1, WORLD], lr=LR,
                                         seed_by_rank=True)])


# ---------------------------------------------------------------- the plan


def _specs(spec):
    return setvae_param_specs(_model(spec))


def test_param_specs_shard_attention_and_ffn():
    """q/k/v column-wise, out row-wise, the FFN up column-wise and down
    row-wise; the norms, embedding, latent heads and the decoder's last
    projection (also named `out`) whole."""
    specs = _specs(TINY)
    for layer in ("encoder.layers.0.", "decoder.layers.0."):
        attn = layer + "self_attn."
        for role in ("query", "key", "value"):
            assert specs[attn + role + ".weight"] == COL
            assert specs[attn + role + ".bias"] == ("model",)
        assert specs[attn + "out.weight"] == ROW and specs[attn + "out.bias"] == ()
        assert specs[layer + "ff_up.weight"] == COL and specs[layer + "ff_up.bias"] == ("model",)
        assert specs[layer + "ff_down.weight"] == ROW and specs[layer + "ff_down.bias"] == ()
    for name in ("encoder.embed.weight", "encoder.fc_mu.weight", "decoder.memory.weight",
                 "decoder.out.weight", "decoder.query_embed", "encoder.layers.0.norm1.weight"):
        assert specs[name] == (), name


def test_structural_specs_census():
    """Exact split-leaf census of the tiny model: an encoder layer holds
    3 q/k/v weights + 3 biases + the out weight + FFN up weight, up bias,
    down weight = 10; a decoder layer 2 x 7 + 3 = 17."""
    specs = _specs(TINY)
    assert sum("model" in s for s in specs.values()) == 2 * 10 + 2 * 17


def test_square_ffn_kernels_keep_megatron_pairing():
    """ff_dim == d_model makes the FFN weights square: the names break the
    tie (up column-wise, down row-wise) instead of replicating the FFN."""
    specs = _specs(dict(TINY, model_params=dict(TINY["model_params"], ff_dim=16)))
    for layer in ("encoder.layers.0.", "decoder.layers.0."):
        assert specs[layer + "ff_up.weight"] == COL
        assert specs[layer + "ff_down.weight"] == ROW


def test_narrow_ffn_keeps_megatron_pairing():
    """ff_dim < d_model: the up projection has fewer outputs than inputs.
    JAX's shape rule (up = more outputs) would swap up and down, which
    GSPMD partitions either way; the port's column/row pairing needs the
    true roles, read from the layer's width."""
    specs = _specs(WIDE)
    assert WIDE["model_params"]["ff_dim"] < WIDE["model_params"]["d_model"]
    for layer in ("encoder.layers.0.", "decoder.layers.0."):
        assert specs[layer + "ff_up.weight"] == COL
        assert specs[layer + "ff_down.weight"] == ROW


SQUARE = dict(TINY, model_params=dict(TINY["model_params"], ff_dim=16))


@pytest.mark.parametrize("spec", [TINY, SQUARE, WIDE], ids=["wide_ffn", "square_ffn",
                                                           "narrow_ffn"])
def test_param_specs_match_jax(spec):
    """Every leaf's placement is JAX setvae_param_specs' on the same
    parameter tree, in the Flax layout, but where ff_dim < d_model: there
    JAX's up = more-outputs rule gives the FFN's up projection the down
    projection's placement and the other way round (intentional, see
    test_narrow_ffn_keeps_megatron_pairing)."""
    model = _model(spec)
    ndim = {n: p.dim() for n, p in model.named_parameters()}
    got = {n: port_spec_as_flax(n, s, ndim[n]) for n, s in setvae_param_specs(model).items()}
    jspecs = jax_tp.setvae_param_specs(weights.state_dict_to_variables(model.state_dict())
                                       ["params"])
    want = {n: jax_spec_at(jspecs, n, ndim[n]) for n in ndim}
    mp = spec["model_params"]
    if mp["ff_dim"] < mp["d_model"]:
        for up in [n for n in ndim if ".ff_up." in n]:
            down = up.replace(".ff_up.", ".ff_down.")
            assert (want[up], want[down]) == (got[down], got[up]), up
            for n in (up, down):
                del got[n], want[n]
    assert got == want


@pytest.mark.parametrize("spec", [TINY, SQUARE], ids=["wide_ffn", "square_ffn"])
def test_tp_fsdp_specs_match_jax(spec):
    """TP x FSDP's merged placements (the plan's 'model' axis kept, the
    largest free axis on 'data') are JAX merge_tp_fsdp_specs' on the same
    tree, with every leaf eligible and with a size floor."""
    model = _model(spec)
    ndim = {n: p.dim() for n, p in model.named_parameters()}
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = weights.state_dict_to_variables(model.state_dict())["params"]
    for mse in (0, 2 ** 8):
        got = merge_tp_fsdp_specs(shapes, setvae_param_specs(model), 2, mse)
        jspecs = jax_merge_tp_fsdp_specs(params, jax_tp.setvae_param_specs(params), 2, mse)
        for n in ndim:
            assert port_spec_as_flax(n, got[n], ndim[n]) == jax_spec_at(jspecs, n, ndim[n]), \
                (n, mse)


def test_tp_coverage_invariant_raises():
    """A transformer layer that no structural rule splits fails loudly
    instead of training replicated; the checker runs on a spec map too."""

    class TransformerEncoderLayer(nn.Module):
        def __init__(self):
            super().__init__()
            self.mystery = Dense(8, 8)

    bad = nn.Sequential(TransformerEncoderLayer())
    with pytest.raises(ValueError, match="zero 'model'-sharded"):
        setvae_param_specs(bad)
    check_tp_coverage({"0.query.weight": COL}, ["0"])


def test_tp_refuses_fused_qkv(monkeypatch):
    """VST_FUSED_QKV=1 cuts the heads at other places than the column-wise
    plan: refused on a mesh with a 'model' axis, allowed without one."""
    model = _model(TINY)
    monkeypatch.setenv("VST_FUSED_QKV", "1")
    with pytest.raises(ValueError, match="VST_FUSED_QKV"):
        check_flash_partitionable(model, types.SimpleNamespace(mesh_dim_names=("data", "model")))
    check_flash_partitionable(model, types.SimpleNamespace(mesh_dim_names=("data",)))


# ---------------------------------------------------------------- the step


def _single_step(phase):
    saved = {k: os.environ.get(k) for k in phase.get("env", {})}
    os.environ.update(phase.get("env", {}))
    try:
        model = _model(phase)
        opt = make_optimizer(model.parameters(), lr=phase["lr"])
        m = make_train_step(model, opt)(torch.from_numpy(phase["x"]),
                                        torch.from_numpy(phase["eps"]), phase["wu"])
    finally:
        for k, v in saved.items():
            os.environ.pop(k) if v is None else os.environ.__setitem__(k, v)
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in m.items()}, grads, model


# Bounds on (loss terms, gradients, share of parameter elements apart by
# more than lr/100) against the port's single-device step: both sides run
# the same code and round the attention's q, k, v and P to bf16 at the
# same points; TP cuts the f32 sums of the row-wise projections at other
# places. Measured over the five steps (here and in
# test_torch_parallel_tp_fsdp.py): loss terms 1.9e-7, gradients 2.5e-6
# (TP x FSDP; TP 3.5e-7), share 7.9e-6; each bound about 10x that.
BOUNDS = (2e-6, 3e-5, 1e-4)
# Bounds on (loss terms, gradients, share, BatchNorm statistics: none
# here) against the JAX package's step of the same strategy: its
# attention on the CPU (XLA) rounds at other points than the port's plain
# version, as on one device, so these are tests/test_torch_train.py's
# CPU_F32_BOUNDS for the same models in f32 (first-step loss terms,
# gradients, share). Measured: loss terms 3.5e-5, gradients 4.8e-3,
# share 2.9e-2 (TP on 1 x 2).
JAX_BOUNDS = (5e-4, 0.05, 0.6, 0.0)
ROUTES = {"tp": ("dense_attention_fwd", 2), "tp_one_head": ("dense_attention", 1),
          "tp_fused_ffn": ("dense_attention_fwd", 2), "tp_dp": ("dense_attention_fwd", 2),
          "tp_fsdp": ("dense_attention_fwd", 2)}


def _gaps(got, ref):
    """(loss terms, max relative; gradients, relative L2; share of
    parameter elements the update leaves apart by more than lr/100) of a
    rank's step against the single-device step. The key biases' gradient
    is zero analytically: roundoff on both sides, left out."""
    m, grads, model = ref
    loss = max(abs(got["metrics"][k] - m[k]) / max(abs(m[k]), 1e-6) for k in m)
    keys = [k for k in grads if not k.endswith("key.bias")]
    assert set(got["grads"]) == set(grads)
    g = (sum(float(((got["grads"][k] - grads[k]) ** 2).sum()) for k in keys)
         / sum(float((grads[k] ** 2).sum()) for k in keys)) ** 0.5
    after = dict(model.named_parameters())
    share = float(np.mean(np.concatenate([
        (np.abs(got["state"][k] - after[k].detach().numpy()) > LR / 100).reshape(-1)
        for k in keys])))
    return loss, g, share


def check_step(runs, name, world):
    """One strategy step against the single-device step on the global
    batch within BOUNDS; every rank holds the same state; each attention
    runs its local heads on the route the JAX gate gives them."""
    got = runs["outs"][0][name]
    gaps = _gaps(got, runs["refs"][name])
    assert all(d <= b for d, b in zip(gaps, BOUNDS)), (gaps, BOUNDS)
    route, heads = ROUTES[name]
    assert got["routes"][route] > 0 and set(got["heads"]) == {heads}, got
    for r in range(1, world):
        for k, v in got["state"].items():
            np.testing.assert_array_equal(runs["outs"][r][name]["state"][k], v)


def check_jax_step(runs, name):
    """One strategy step against the JAX package's step of the same
    strategy (make_tp_dp_train_step, make_tp_fsdp_train_step) on the same
    weights, global batch and noise, within JAX_BOUNDS."""
    gaps = sharded_jax_gaps(runs["outs"][0][name], runs["jax_refs"][name], LR)
    assert all(d <= b for d, b in zip(gaps, JAX_BOUNDS)), (gaps, JAX_BOUNDS)


@pytest.mark.parametrize("name", list(STEPS))
def test_tp_step_matches_single_device(runs, name):
    """TP on 1 x 2: two local heads of 64 (packed), one (BHND, where one
    device runs the packed kernels on its two), the fused FFN."""
    check_step(runs, name, WORLD)


@pytest.mark.parametrize("name", list(STEPS))
def test_tp_step_matches_jax(runs, name):
    """The same three TP steps against JAX make_tp_dp_train_step on a
    1 x 2 mesh of virtual devices (JAX computes the fused FFN's case
    unfused: its kernel runs on the TPU only)."""
    check_jax_step(runs, name)


def test_tp_fused_ffn_runs_gathered(runs):
    """Under VST_FUSED_FFN=1 every encoder FFN of a TP step takes the fused
    op on the gathered weights (JAX's kernel has no partition rule: GSPMD
    runs it whole)."""
    assert runs["outs"][0]["tp_fused_ffn"]["routes"]["fused_ffn"] > 0
    assert runs["outs"][0]["tp"]["routes"]["fused_ffn"] == 0


def test_tp_starts_from_the_first_ranks_state(runs):
    """Ranks that drew their weights apart (seeded by rank) hold the first
    rank's after tp.shard_state: the column- and row-wise leaves and the
    replicated ones alike."""
    want = _model(TINY).state_dict()
    for out in runs["outs"]:
        for k, v in want.items():
            np.testing.assert_array_equal(out["replicated"]["state"][k], v.numpy(), err_msg=k)


# ---------------------------------------------------------------- the trainer


def check_trainer(runs, name, world):
    """The same seed, data and noise land on the single-device run (eval
    loss rtol 1e-4; parameters within the update budget n_steps * lr, JAX
    test_trainer_tp_sp.py:47); only rank 0 wrote."""
    got = runs["outs"][0]["train_" + name]
    np.testing.assert_allclose(got["eval"]["loss"], runs["single"]["eval"]["loss"], rtol=1e-4)
    steps = runs["single_state"].step
    assert got["step"] == steps
    for k, v in runs["single_state"].model.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), atol=steps * TRAIN["lr"], rtol=0)
    for r in range(1, world):
        assert not os.path.exists(runs["outs"][r]["train_" + name]["result_dir"])


@pytest.mark.parametrize("name", ["tp"])
def test_tp_trainer_matches_single_device(runs, name):
    """tensor_parallel 2 on two ranks (a 1 x 2 mesh)."""
    check_trainer(runs, name, WORLD)
