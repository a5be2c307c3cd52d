"""Pipeline parallelism (parallel/pp.py, parallel/pp_setvae.py) on two
gloo ranks on the CPU: the generic GPipe against the single-device stacked
layers, forward and gradients (JAX tests/test_pp.py:31,58); the SetVAE
and SetLRVAE encoder pipelines against the port's single-device step and
against JAX make_setvae_pp_train_step on two virtual devices (JAX
tests/test_pp_setvae.py), with a norm clip that a pipeline gradient off
by the stage count would fail; split/merge round trips of the parameters
and the Adam state against JAX's split_params; the trainer's
pipeline_parallel path for both models against the single-device trainer
and its checkpoint resumed on one device. DP x PP on 2 x 2 is
tests/test_torch_parallel_dryrun.py's.

One process group of two ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import glob

import jax
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401
from test_torch_parallel_sp import (JAX_BOUNDS, check_jax, check_step, check_trainer,
                                    run_file, step_phase)
from test_torch_parallel_tp import TRAIN, TRAINER_MODEL
from torch_parallel_worker import _model, residual_block
from vae_song_tpu.parallel import pp_setvae as jax_pp_setvae
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.parallel import pp, pp_setvae
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import TrainState, adam_state, make_optimizer

WORLD = 2
SET = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=9,
           model_params=dict(latent_channel=8, num_points=32, d_model=16, num_heads=2,
                             ff_dim=32, num_encoder_layers=2, num_decoder_layers=1))
LRSET = dict(SET, exp_type="setlrvae", alpha=0.1, seed=10)
CLIP = {"enabled": True, "clip_type": "norm", "max_norm": 0.05, "norm_type": 2.0}
# Bounds on (loss terms, gradients, share) against the port's single-device
# step: the same layers on the same microbatches; the pipeline cuts the
# batch into microbatches and sums the stages' and the passes' parts in
# other orders. Measured over the three PP steps here and the two DP x PP
# ones in test_torch_parallel_dryrun.py: loss terms 0, gradients 1.2e-8,
# share 0; bounds: the gradients about 10x that, the loss terms a few f32
# roundings, the share a handful of elements.
PP_BOUNDS = (1e-6, 2e-7, 1e-4)
STEPS = {
    "pp_setvae": step_phase("pp_setvae", SET, "pp", [1, WORLD], 4, 0, n_micro=2),
    "pp_setlrvae": step_phase("pp_setlrvae", LRSET, "pp", [1, WORLD], 4, 1, n_micro=2),
    "pp_clip": step_phase("pp_clip", LRSET, "pp", [1, WORLD], 4, 2, n_micro=4,
                          grad_clip=CLIP),
}


def _generic_phase(seed=3, n_layers=4, d=8, b=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: (0.3 * rng.normal(size=s)).astype(np.float32)  # noqa: E731
    return dict(fn="pp_generic", name="generic", n=WORLD, n_micro=4, w=f(n_layers, d, d),
                b=f(n_layers, d), x=f(b, d), t=f(b, d))


GENERIC = _generic_phase()
LR_TRAINER = dict(TRAINER_MODEL, exp_type="setlrvae", alpha=0.1)


# JAX's clip case compiles a third pipeline (13 s); the port's clip is held
# to the single-device step's optax clip here, and to its norm below
JAX_STEPS = ("pp_setvae", "pp_setlrvae")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield run_file(tmp_path_factory, "pp", WORLD, STEPS, JAX_STEPS, {
        "train_pp": (TRAINER_MODEL, {"pipeline_parallel": 2, "checkpoint_every": 1}),
        "train_pp_lr": (LR_TRAINER, {"pipeline_parallel": 2}),
    }, {"set": TRAINER_MODEL, "lr": LR_TRAINER}, extra=[GENERIC])


# ---------------------------------------------------------------- the generic schedule


def test_generic_pipeline_matches_stacked_layers(runs):
    """Four residual blocks on two stages, four microbatches: the pipelined
    forward and each stage's gradients against the stacked layers run in
    order on one device (JAX test_pp.py:31,58); raw gradients, so a
    pipeline gradient scaled by the stage count fails here."""
    stacked = {k: torch.from_numpy(GENERIC[k]).requires_grad_() for k in ("w", "b")}
    x, t = torch.from_numpy(GENERIC["x"]), torch.from_numpy(GENERIC["t"])
    y = pp.scan_blocks(residual_block, stacked, x)
    loss = ((y - t) ** 2).mean()
    loss.backward()
    got = [o["generic"] for o in runs["outs"][:WORLD]]
    for g in got:
        np.testing.assert_allclose(g["loss"], loss.item(), rtol=1e-6)
        np.testing.assert_allclose(g["y"], y.detach().numpy(), atol=1e-6, rtol=0)
    for k, v in stacked.items():
        np.testing.assert_allclose(np.concatenate([g["grads"][k] for g in got]),
                                   v.grad.numpy(), atol=1e-7, rtol=1e-5, err_msg=k)


def test_stack_block_params_layout():
    gen = torch.Generator().manual_seed(0)
    stacked = pp.stack_block_params(lambda g: {"w": torch.randn(3, 3, generator=g)}, gen, 4)
    assert stacked["w"].shape == (4, 3, 3)


# ---------------------------------------------------------------- the SetVAE step


@pytest.mark.parametrize("name", list(STEPS))
def test_pp_step_matches_single_device(runs, name):
    """SetVAE and SetLRVAE (two pipeline passes) on two stages, and SetLRVAE
    with a norm clip: each stage's layers, the summed input projection
    and the averaged rest against the single-device step."""
    check_step(runs, name, WORLD, PP_BOUNDS)


@pytest.mark.parametrize("name", JAX_STEPS)
def test_pp_step_matches_jax(runs, name):
    """SetVAE and SetLRVAE against JAX make_setvae_pp_train_step on a
    ('stage',) mesh of two virtual devices, the same eps."""
    check_jax(runs, name, WORLD, JAX_BOUNDS)


def test_pp_clip_binds_with_the_true_global_norm(runs):
    """The clip was active (the unclipped gradient's norm is above
    max_norm): the clipped gradient, merged over the stages, has norm
    max_norm, so each stage scaled by the norm of every stage's layers."""
    got = runs["outs"]
    grads = {k: v for r in range(WORLD) for k, v in got[r]["pp_clip"]["grads"].items()}
    norm = np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in grads.values()))
    np.testing.assert_allclose(norm, CLIP["max_norm"], rtol=1e-5)


def test_pp_stages_train_their_own_layers(runs):
    """A stage holds gradients for its encoder layers only, and for every
    parameter outside the encoder's layers; after pp_sync every rank holds
    the same parameters and Adam moments."""
    for r in range(WORLD):
        names = runs["outs"][r]["pp_setvae"]["grads"]
        layers = {n.split(".")[2] for n in names if n.startswith("encoder.layers.")}
        assert layers == {str(r)}
    a, b = (runs["outs"][r]["pp_setvae"] for r in range(WORLD))
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k])
    for k in a["mu"]:
        np.testing.assert_array_equal(a["mu"][k], b["mu"][k])


# ---------------------------------------------------------------- the split


def test_split_merge_round_trips():
    """split_params lays the state_dict out as JAX's split_params does (the
    same stacked shapes, in the Flax layout); merge_params and
    merge_opt_state invert the splits."""
    model = _model(LRSET)
    sd = model.state_dict()
    split = pp_setvae.split_params(sd, 2)
    merged = pp_setvae.merge_params(split, 2)
    assert list(merged) != [] and set(merged) == set(sd)
    for k, v in sd.items():
        assert torch.equal(merged[k], v), k
    jsplit = jax_pp_setvae.split_params(
        weights.state_dict_to_variables(sd)["params"], 2)
    assert (sum(v.size for v in jax.tree.leaves(jsplit["enc_stack"]))
            == sum(v.numel() for v in split["enc_stack"].values()))
    assert {k: () for k in split["pre"]} == pp_setvae.pp_param_specs(split)["pre"]
    state = TrainState(model, make_optimizer(model.parameters(), lr=1e-3))
    opt = adam_state(state)
    back = pp_setvae.merge_opt_state(pp_setvae.split_opt_state(opt, 2), 2)
    assert back["count"] == opt["count"]
    for k, v in opt["mu"].items():
        assert torch.equal(back["mu"][k], v)


# ---------------------------------------------------------------- the trainer


@pytest.mark.parametrize("name,single", [("pp", "set"), ("pp_lr", "lr")])
def test_pp_trainer_matches_single_device(runs, name, single):
    """pipeline_parallel 2 on two ranks, SetVAE and SetLRVAE, lands on the
    single-device run; only rank 0 wrote."""
    check_trainer(runs, name, WORLD, single)


def test_pp_checkpoint_resumes_single_device(runs, tmp_path, one_thread):
    """The pipeline run's ckpt_0.pkl (written after pp_sync brought every
    layer and its Adam moments to rank 0) resumes on one device and lands
    on the pipeline run within the second epoch's update budget."""
    (ckpt,) = glob.glob(str(runs["tmp"] / "train_pp" / "results" / "*" / "*" / "params"
                            / "ckpt_0.pkl"))
    state, summary = train_and_test(_model(TRAINER_MODEL), device="cpu", resume_from=ckpt,
                                    output_root=str(tmp_path), **TRAIN)
    got = runs["outs"][0]["train_pp"]
    assert state.step == got["step"]
    np.testing.assert_allclose(summary["eval"]["loss"], got["eval"]["loss"], rtol=1e-4)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got["state"][k], atol=4 * TRAIN["lr"], rtol=0)
