"""Expert parallelism (parallel/ep.py: moe_ffn_ep over all_to_all, the
expert stacks split one expert a rank) on two gloo ranks on the CPU: the
standalone MoE's forward and regression step against the dense MoE on
each shard (JAX tests/test_ep.py); the SetVAE EP step against data
parallelism with the dense MoE on each shard (JAX
tests/test_moe_setvae.py:85: the capacity is the local one, so this, and
not the single-device step, is its reference), with a capacity that drops
tokens and with a norm clip, and against JAX make_setvae_ep_train_step on
two virtual devices; the trainer's expert_parallel path against its
data_parallel run of the same MoE model.

One process group of two ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import os

import numpy as np
import pytest
import torch

from test_torch_parallel_sp import JAX_BOUNDS, check_jax, check_step, run_file, step_phase
from test_torch_parallel_tp import TRAIN, TRAINER_MODEL
from torch_parallel_worker import _model
from vae_song_tpu_torch.parallel import ep

WORLD = 2
MOE = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=11,
           model_params=dict(latent_channel=8, num_points=16, d_model=16, num_heads=2,
                             ff_dim=32, num_encoder_layers=1, num_decoder_layers=1,
                             moe_experts=WORLD))
# capacity factor 0.5: C = ceil(32 / 2 * 0.5) = 8 of a shard's 32 tokens an
# expert, so tokens are dropped; per shard, as the dense MoE on each shard
TIGHT = dict(MOE, model_params=dict(MOE["model_params"], moe_capacity_factor=0.5))
CLIP = {"enabled": True, "clip_type": "norm", "max_norm": 0.05, "norm_type": 2.0}
# Bounds on (loss terms, gradients, share) against data parallelism with the
# dense MoE on each shard: the same routing and products; the EP step
# exchanges the tokens and sums the expert gradients' rank parts in
# another order. Measured over the three steps: loss terms 0, gradients
# 2.5e-9, share 0; bounds: the gradients about 10x that, the loss terms a
# few f32 roundings, the share a handful of elements.
EP_BOUNDS = (1e-6, 3e-8, 1e-4)
STEPS = {
    "ep": step_phase("ep", MOE, "ep", [WORLD], 4, 0),
    "ep_tight": step_phase("ep_tight", TIGHT, "ep", [WORLD], 4, 1),
    "ep_clip": step_phase("ep_clip", MOE, "ep", [WORLD], 4, 2, grad_clip=CLIP),
    # a noise block of its own for each rank's shard (the port's reference only)
    "ep_rows": step_phase("ep_rows", MOE, "ep", [WORLD], 4, 3, tiled=False),
}
JAX_STEPS = ("ep",)


def _generic_phase(seed=4, tokens=32, d=8, hidden=16):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(fn="ep_generic", name="generic", n=WORLD, seed=seed, hidden=hidden, cf=1.0,
                x=f(tokens, d), t=f(tokens, d))


GENERIC = _generic_phase()
MOE_TRAINER = dict(TRAINER_MODEL, model_params=dict(TRAINER_MODEL["model_params"],
                                                    moe_experts=WORLD))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield run_file(tmp_path_factory, "ep", WORLD, STEPS, JAX_STEPS, {
        "train_ep": (MOE_TRAINER, {"expert_parallel": True}),
        "train_dp": (MOE_TRAINER, {"data_parallel": True}),
    }, {}, extra=[GENERIC])


def test_moe_ep_matches_dense_per_shard(runs):
    """make_ep_apply on each rank's tokens is the dense MoE on that shard
    (the capacity of the shard's tokens); the regression step's loss is
    the global mean and its gradients, the router's summed over the
    ranks and each expert's complete on its rank, are the dense
    per-shard loss's."""
    g = GENERIC
    d = g["x"].shape[1]
    init = ep.init_moe(d, g["hidden"], WORLD, torch.Generator().manual_seed(g["seed"]))
    params = ep.MoEParams(*(t.requires_grad_() for t in init))
    x, t = torch.from_numpy(g["x"]), torch.from_numpy(g["t"])
    ys = [ep.moe_ffn_dense(params, xs, g["cf"]) for xs in x.chunk(WORLD)]
    loss = sum(((y - ts) ** 2).sum() for y, ts in zip(ys, t.chunk(WORLD))) / (x.shape[0] * d)
    loss.backward()
    got = [o["generic"] for o in runs["outs"][:WORLD]]
    for r in range(WORLD):
        np.testing.assert_allclose(got[r]["y"], ys[r].detach().numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(got[r]["loss"], loss.item(), rtol=1e-6)
        for f, p in zip(ep.MoEParams._fields, params):
            np.testing.assert_allclose(got[r]["grads"][f], p.grad.numpy(), atol=1e-7,
                                       rtol=1e-5, err_msg=f)


@pytest.mark.parametrize("name", list(STEPS))
def test_ep_step_matches_dp_dense_per_shard(runs, name):
    """The EP step of SetVAE with two MoE experts, one a rank (also with a
    capacity that drops tokens, and with a norm clip), against data
    parallelism over the same two shards with the dense MoE on each:
    expert gradients over the rank count, the others averaged."""
    check_step(runs, name, WORLD, EP_BOUNDS)


@pytest.mark.parametrize("name", JAX_STEPS)
def test_ep_step_matches_jax(runs, name):
    """Against JAX make_setvae_ep_train_step on two virtual devices, from
    the same weights, clouds and eps."""
    check_jax(runs, name, WORLD, JAX_BOUNDS)


def test_ep_splits_the_expert_stacks():
    """setvae_ep_specs: the MoE FFNs' w1, b1, w2, b2 on 'expert', the
    router and every other parameter whole (JAX setvae_ep_specs)."""
    specs = ep.setvae_ep_specs(_model(MOE))
    split = {n for n, s in specs.items() if s}
    assert split and all(n.rsplit(".", 1)[-1] in ("w1", "b1", "w2", "b2") for n in split)
    assert specs["encoder.layers.0.moe_ffn.router"] == ()
    assert len(split) == 4 * 2


def test_ep_trainer_matches_dp_trainer(runs):
    """expert_parallel with moe_experts 2 on two ranks against the
    data_parallel run of the same model: the same per-shard semantics
    (eval loss rtol 1e-4, parameters within the update budget); only rank
    0 wrote, and its exported state is whole."""
    got, want = runs["outs"][0]["train_ep"], runs["outs"][0]["train_dp"]
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=1e-4)
    assert got["step"] == want["step"]
    for k, v in want["state"].items():
        assert got["state"][k].shape == v.shape, k
        np.testing.assert_allclose(got["state"][k], v, atol=want["step"] * TRAIN["lr"], rtol=0)
    assert not os.path.exists(runs["outs"][1]["train_ep"]["result_dir"])
