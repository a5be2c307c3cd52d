"""The 2 x 2 meshes of sequence and pipeline parallelism and the port's
multi-rank dry run (parallel/dryrun.py), on four gloo ranks on the CPU:
DP x SP and DP x PP steps against the data-parallel convention over the
two rows with the port's single-device step, and against JAX
make_sp_train_step and make_setvae_pp_train_step on 2 x 2 meshes of
virtual devices; the trainer's data_parallel x sequence_parallel and
data_parallel x pipeline_parallel paths against the single-device
trainer; every strategy's one-step parity in `dryrun_multichip(4)` (JAX
__graft_entry__.py:94), on the same ranks. The helpers and bounds are
tests/test_torch_parallel_sp.py's and test_torch_parallel_pp.py's.

One process group of four ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import pytest

from test_torch_parallel_pp import LRSET, PP_BOUNDS, SET
from test_torch_parallel_sp import (BOUNDS, JAX_BOUNDS, TINY, check_jax, check_step,
                                    check_trainer, run_file, step_phase)
from test_torch_parallel_tp import TRAINER_MODEL

WORLD = 4
STEPS = {
    "dp_sp": step_phase("dp_sp", TINY, "sp", [2, 2], 4, 3),
    "dp_pp": step_phase("dp_pp", LRSET, "pp", [2, 2], 4, 4, n_micro=2),
}
# the DP x PP step of SetVAE too, and DP x SP and DP x PP with a noise block
# of its own for each row, held to the port's reference only
STEPS["dp_pp_setvae"] = step_phase("dp_pp_setvae", SET, "pp", [2, 2], 8, 5, n_micro=2)
STEPS["dp_sp_rows"] = step_phase("dp_sp_rows", TINY, "sp", [2, 2], 4, 6, tiled=False)
STEPS["dp_pp_rows"] = step_phase("dp_pp_rows", LRSET, "pp", [2, 2], 4, 7, tiled=False,
                                 n_micro=2)
JAX_STEPS = ("dp_sp", "dp_pp")
STEP_BOUNDS = {"dp_sp": BOUNDS, "dp_pp": PP_BOUNDS, "dp_pp_setvae": PP_BOUNDS,
               "dp_sp_rows": BOUNDS, "dp_pp_rows": PP_BOUNDS}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    # one epoch, 4 steps (as tests/test_torch_parallel_tp.py's TP run): over
    # a second one a bf16 rounding of the sharded attention that lands the
    # other way on one side grows DP x SP's eval-loss gap from 2.9e-7 to 5.1e-4
    yield run_file(tmp_path_factory, "dryrun", WORLD, STEPS, JAX_STEPS, {
        "train_dp_sp": (TRAINER_MODEL, {"sequence_parallel": 2, "data_parallel": True}),
        "train_dp_pp": (TRAINER_MODEL, {"pipeline_parallel": 2, "data_parallel": True}),
    }, {"set": TRAINER_MODEL}, extra=[dict(fn="dryrun", name="dryrun")], epochs=1)


@pytest.mark.parametrize("name", list(STEPS))
def test_2x2_step_matches_data_parallel_reference(runs, name):
    """DP x SP (SetLRVAE) and DP x PP (SetLRVAE, SetVAE) on 2 x 2: the mean
    of the two rows' single-device gradients, then the update; every rank
    the same state. The `_rows` cases give each row a noise block of its
    own."""
    check_step(runs, name, WORLD, STEP_BOUNDS[name])


@pytest.mark.parametrize("name", JAX_STEPS)
def test_2x2_step_matches_jax(runs, name):
    """Against JAX make_sp_train_step and make_setvae_pp_train_step on 2 x 2
    meshes of virtual devices (every row's shards draw the same eps
    block, as each port row takes it)."""
    check_jax(runs, name, WORLD, JAX_BOUNDS)


@pytest.mark.parametrize("name", ["dp_sp", "dp_pp"])
def test_2x2_trainer_matches_single_device(runs, name):
    """data_parallel x sequence_parallel 2 and data_parallel x
    pipeline_parallel 2 on four ranks land on the single-device run (the
    set models' losses are batch means: the rows' mean is the global
    batch's); only rank 0 wrote."""
    check_trainer(runs, name, WORLD)


def test_dryrun_multichip_on_four_ranks(runs):
    """Every strategy's one-step parity on the four ranks, asserted inside
    the dry run (bounds JAX's: 1e-4 DP, PP, DP x PP; 1e-3 the others):
    DP (and its updated parameters), DP x TP, DP x SP, PP, DP x PP, EP,
    FSDP, the same on every rank."""
    deltas = [o["dryrun"]["deltas"] for o in runs["outs"]]
    assert set(deltas[0]) == {"DP", "DP params", "DPxTP", "DPxSP", "PP", "DPxPP", "EP", "FSDP"}
    assert all(d == deltas[0] for d in deltas)
