"""TP x DP and TP x FSDP (parallel/tp.py, parallel/fsdp.py) on a 2 x 2
mesh of four gloo ranks on the CPU: each step against the single-device
step on the global batch (JAX tests/test_tp.py:128, test_fsdp.py:176)
and against JAX's steps of the same strategies on virtual devices,
both axes of a TP x FSDP leaf split, the trainer's paths against the
single-device trainer (test_trainer_tp_sp.py:47, test_fsdp.py:212) and a
TP x FSDP checkpoint resumed on one device. The helpers and bounds are
tests/test_torch_parallel_tp.py's.

One process group of four ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import glob

import numpy as np
import pytest

from jax_parity import one_thread  # noqa: F401
from test_torch_parallel_tp import (TRAIN, TRAINER_MODEL, WIDE, _step, check_jax_step,
                                    check_step, check_trainer, run_file)
from torch_parallel_worker import _model
from vae_song_tpu_torch.train.loop import train_and_test

WORLD = 4
STEPS = {
    "tp_dp": _step("tp_dp", WIDE, "tp_dp", [2, 2], 8, 1),
    "tp_fsdp": _step("tp_fsdp", WIDE, "tp_fsdp", [2, 2], 8, 2, min_shard_elems=0),
}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield run_file(tmp_path_factory, "tp_fsdp", WORLD, STEPS, {
        "train_tp_dp": {"tensor_parallel": 2, "data_parallel": True},
        "train_tp_fsdp": {"tensor_parallel": 2, "fsdp": True, "checkpoint_every": 1}})


@pytest.mark.parametrize("name", list(STEPS))
def test_tp_step_matches_single_device(runs, name):
    """TP x DP and TP x FSDP on 2 x 2: two local heads of 64 (packed)."""
    check_step(runs, name, WORLD)


@pytest.mark.parametrize("name", list(STEPS))
def test_tp_step_matches_jax(runs, name):
    """TP x DP and TP x FSDP against JAX make_tp_dp_train_step and
    make_tp_fsdp_train_step on a 2 x 2 mesh of virtual devices."""
    check_jax_step(runs, name)


def test_tp_fsdp_shards_both_axes(runs):
    """TP x FSDP: an FFN up weight [ff, d] holds ff / 2 rows ('model') and
    d / 2 columns ('data') on a rank, its first moment too; under TP x DP
    only the rows are split."""
    got = runs["outs"][0]["tp_fsdp"]
    name = "encoder.layers.0.ff_up.weight"
    assert got["local"][name] == [128 // 2, 256 // 2] == got["mu_local"][name]
    assert runs["outs"][0]["tp_dp"]["local"][name] == [128 // 2, 256]


@pytest.mark.parametrize("name", ["tp_dp", "tp_fsdp"])
def test_tp_trainer_matches_single_device(runs, name):
    """tensor_parallel 2 x data_parallel and tensor_parallel 2 x fsdp."""
    check_trainer(runs, name, WORLD)


def test_tp_fsdp_checkpoint_resumes_single_device(runs, tmp_path, one_thread):
    """The TP x FSDP run's ckpt_0.pkl, gathered into the single-device
    format by rank 0, resumes on one device and lands on the TP x FSDP
    run within the second epoch's update budget."""
    (ckpt,) = glob.glob(str(runs["tmp"] / "train_tp_fsdp" / "results" / "*" / "*" / "params"
                            / "ckpt_0.pkl"))
    state, summary = train_and_test(_model(TRAINER_MODEL), device="cpu", resume_from=ckpt,
                                    output_root=str(tmp_path), **TRAIN)
    got = runs["outs"][0]["train_tp_fsdp"]
    assert state.step == got["step"]
    np.testing.assert_allclose(summary["eval"]["loss"], got["eval"]["loss"], rtol=1e-4)
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), got["state"][k], atol=4 * TRAIN["lr"], rtol=0)
