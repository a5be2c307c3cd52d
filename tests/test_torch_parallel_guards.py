"""The port trainer's strategy guards, with the JAX trainer's conditions
and messages (JAX tests/test_trainer_tp_sp.py:107,115,139,
tests/test_fsdp.py:143; loop.py:349-412, 440-467, 551-577 and the PP
step's refusals, parallel/pp_setvae.py:199-217), and FSDP on one
process: `fsdp: true` without a launcher opens a one-rank gloo group,
trains as the single-device run does, and closes the group; the dry
run's launcher (parallel/dryrun.py): NCCL ranks on the cards, gloo ranks
only when asked for. Nothing here starts another process."""

import numpy as np
import pytest
import torch
import torch.distributed as dist

from jax_parity import one_thread  # noqa: F401
from torch_parallel_worker import _model
from vae_song_tpu_torch.train.loop import train_and_test

SET = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=8,
           model_params=dict(latent_channel=8, num_points=16, d_model=16, num_heads=2,
                             ff_dim=32, num_encoder_layers=2, num_decoder_layers=1))
COMMON = dict(epochs=2, batch_size=16, dataset_name="shapenet", resultname="res_guard",
              dataset_params={"fake": True, "num_samples": 32, "num_points": 16,
                              "num_test_samples": 16},
              visualize_artifacts=False, progress=False, seed=0, device="cpu", lr=1e-3)


def _train(tmp_path, model=None, **kw):
    return train_and_test(model if model is not None else _model(SET),
                          output_root=str(tmp_path), **dict(COMMON, **kw))


@pytest.mark.parametrize("option,match", [
    ({"tensor_parallel": 2, "pipeline_parallel": 2}, "exclusive"),
    ({"tensor_parallel": 2, "sequence_parallel": 2}, "exclusive"),
    ({"fsdp": True, "pipeline_parallel": 2}, "fsdp and pipeline_parallel are exclusive"),
    ({"fsdp": True, "expert_parallel": True}, "fsdp and expert_parallel are exclusive"),
    ({"grad_accum": 2, "data_parallel": True}, "single-device"),
    ({"grad_accum": 2, "fsdp": True}, "single-device"),
    ({"grad_accum": 2, "tensor_parallel": 2}, "single-device"),
    ({"sequence_parallel_ring": True}, "requires sequence_parallel >= 2"),
])
def test_strategy_guards(tmp_path, option, match):
    """Refused before anything is written or any process group opens."""
    with pytest.raises(ValueError, match=match):
        _train(tmp_path, **option)
    assert not list(tmp_path.iterdir()) and not dist.is_initialized()


MOE = dict(SET, model_params=dict(SET["model_params"], moe_experts=2))
DROPOUT = dict(SET, model_params=dict(SET["model_params"], attn_dropout=0.1))


@pytest.mark.parametrize("spec,option,world,error,match", [
    (MOE, {"expert_parallel": True, "data_parallel": True}, 2, ValueError,
     "expert_parallel and data_parallel are exclusive"),
    (SET, {"expert_parallel": True}, 1, ValueError, r"moe_experts >= 2; got 0"),
    (MOE, {"expert_parallel": True}, 1, ValueError,
     "expert_parallel needs moe_experts=2 devices; have 1"),
    (MOE, {"expert_parallel": True, "batch_size": 15}, 2, ValueError,
     "batch_size=15 must divide over 2 experts"),
    (SET, {"sequence_parallel": 2}, 1, ValueError,
     "sequence_parallel=2 needs that many devices; have 1"),
    (SET, {"sequence_parallel": 2, "data_parallel": True}, 1, ValueError,
     r"data_parallel x sequence_parallel=2 needs >= 4 devices; have 1"),
    (SET, {"sequence_parallel": 3}, 3, ValueError,
     r"num_points=16 must divide evenly over the 'seq' axis \(3 shards\)"),
    (SET, {"sequence_parallel": 2, "data_parallel": True, "batch_size": 15}, 4, ValueError,
     "batch_size=15 must divide over 2 data-parallel shards"),
    (SET, {"pipeline_parallel": 2}, 1, ValueError,
     "pipeline_parallel=2 needs that many devices; have 1"),
    (SET, {"pipeline_parallel": 2, "data_parallel": True}, 2, ValueError,
     r"data_parallel x pipeline_parallel=2 needs >= 4 devices; have 2"),
    (SET, {"pipeline_parallel": 2, "data_parallel": True, "batch_size": 15}, 4, ValueError,
     "batch_size=15 must divide over 2 data-parallel pipelines"),
    (DROPOUT, {"pipeline_parallel": 2}, 2, NotImplementedError,
     "attn_dropout=0.1 is not supported under pipeline parallelism"),
    (MOE, {"pipeline_parallel": 2}, 2, NotImplementedError,
     "moe_experts=2 is not supported under pipeline parallelism"),
    (SET, {"pipeline_parallel": 4}, 4, ValueError,
     "2 encoder layers do not divide over 4 stages"),
], ids=["ep_with_dp", "ep_without_moe", "ep_too_few_ranks", "ep_batch", "sp_too_few_ranks",
        "dp_sp_too_few_ranks", "sp_points", "dp_sp_batch", "pp_too_few_ranks",
        "dp_pp_too_few_ranks", "dp_pp_batch", "pp_dropout", "pp_moe", "pp_layers"])
def test_sequence_pipeline_expert_guards(tmp_path, monkeypatch, spec, option, world, error,
                                         match):
    """JAX's guards of its sequence-, pipeline- and expert-parallel branches,
    with its messages; "devices" are the launch's ranks (WORLD_SIZE here).
    Refused before anything is written or any process group opens."""
    monkeypatch.setenv("WORLD_SIZE", str(world))
    with pytest.raises(error, match=match):
        _train(tmp_path, _model(spec), **option)
    assert not list(tmp_path.iterdir()) and not dist.is_initialized()


def test_sequence_parallel_rejects_non_set_models(tmp_path):
    model = _model(dict(exp_type="lrvae", dataset="pinwheel", beta=0.01, alpha=0.01,
                        model_params=dict(hchans=[8, 8], encoder_type="mlp",
                                          decoder_type="mlp")))
    with pytest.raises(ValueError, match="sequence_parallel shards the POINT axis"):
        _train(tmp_path, model, sequence_parallel=2, dataset_name="pinwheel",
               dataset_params={"num_samples": 64})
    assert not dist.is_initialized()


def test_tensor_parallel_rejects_non_attention_models(tmp_path):
    model = _model(dict(exp_type="lrvae", dataset="pinwheel", beta=0.01, alpha=0.01,
                        model_params=dict(hchans=[8, 8], encoder_type="mlp",
                                          decoder_type="mlp")))
    with pytest.raises(ValueError, match="attention set models"):
        _train(tmp_path, model, tensor_parallel=2, dataset_name="pinwheel",
               dataset_params={"num_samples": 64})
    deepsets = _model(dict(SET, model_params=dict(latent_channel=8, num_points=16,
                                                   use_attention=False)))
    with pytest.raises(ValueError, match="attention set models"):
        _train(tmp_path, deepsets, tensor_parallel=2)


@pytest.mark.parametrize("option,match", [
    ({"tensor_parallel": 2}, "tensor_parallel=2 needs that many devices; have 1"),
    ({"tensor_parallel": 2, "fsdp": True}, r"fsdp x tensor_parallel=2 needs >= 4 devices"),
    ({"tensor_parallel": 2, "data_parallel": True},
     r"data_parallel x tensor_parallel=2 needs >= 4 devices"),
])
def test_tensor_parallel_needs_its_devices(tmp_path, option, match):
    with pytest.raises(ValueError, match=match):
        _train(tmp_path, **option)
    assert not dist.is_initialized()


def test_tensor_parallel_needs_divisible_heads(tmp_path, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "4")
    with pytest.raises(ValueError, match="num_heads=2 must divide over tensor_parallel=4"):
        _train(tmp_path, tensor_parallel=4)
    assert not dist.is_initialized()


def test_fsdp_on_one_process_matches_single_device(tmp_path, one_thread):
    """fsdp: true with no launcher: a one-rank gloo group opened and closed
    by the trainer; the mesh of one shard computes the single-device step
    (parameters within 1e-6 after 4 steps), and the checkpoint it writes
    is the single-device one."""
    state, summary = _train(tmp_path / "fsdp", fsdp=True, checkpoint_every=2)
    assert not dist.is_initialized()
    plain, want = _train(tmp_path / "plain")
    np.testing.assert_allclose(summary["eval"]["loss"], want["eval"]["loss"], rtol=1e-6)
    got = {k: v.full_tensor() if hasattr(v, "full_tensor") else v
           for k, v in state.model.state_dict().items()}
    for k, v in plain.model.state_dict().items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), atol=1e-6, rtol=0)
    assert (tmp_path / "fsdp" / "results").exists()


def test_cpu_run_opens_a_gloo_group_where_a_card_is_visible(tmp_path, monkeypatch, one_thread):
    """The trainer's own group follows the device asked for: device='cpu'
    opens gloo (and CPU meshes) even where a CUDA card is visible."""
    backends = []
    init = dist.init_process_group

    def record(backend=None, **kw):
        backends.append(backend)
        return init(backend, **kw)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "init_process_group", record)
    _, summary = _train(tmp_path, fsdp=True, epochs=1)
    assert backends == ["gloo"] and np.isfinite(summary["eval"]["loss"])
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv,cards,want", [
    ([], 4, (4, "cuda")),
    (["--ranks", "2"], 4, (2, "cuda")),
    (["--device", "cpu"], 4, (4, "cpu")),
    (["--device", "cpu", "--ranks", "2"], 0, (2, "cpu")),
    ([], 0, None),
    (["--ranks", "4"], 2, None),
])
def test_dryrun_launch_follows_the_device(monkeypatch, capsys, argv, cards, want):
    """`python -m vae_song_tpu_torch.parallel.dryrun` starts one NCCL rank a
    visible card by default, gloo ranks on the CPU only with `--device
    cpu`, and refuses (exit code 2, naming `--device cpu`) where fewer
    cards are visible than ranks asked for."""
    from vae_song_tpu_torch.parallel import dryrun

    launched = []

    class Proc:
        def __init__(self, cmd, env):
            launched.append((cmd, env))

        def wait(self):
            return 0

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(dryrun.subprocess, "Popen", Proc)
    code = dryrun.main(argv)
    if want is None:
        assert code == 2 and not launched and "--device cpu" in capsys.readouterr().err
        return
    n, device = want
    assert code == 0 and len(launched) == n
    for r, (cmd, env) in enumerate(launched):
        assert cmd[cmd.index("--device") + 1] == device and cmd[cmd.index("--ranks") + 1] == str(n)
        assert (env["RANK"], env["LOCAL_RANK"], env["WORLD_SIZE"]) == (str(r), str(r), str(n))


def test_dryrun_rank_refuses_cuda_without_a_card(monkeypatch, capsys):
    """A rank launched for the card (torchrun's environment, the default
    device) that finds none refuses before opening a group."""
    from vae_song_tpu_torch.parallel import dryrun

    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert dryrun.main([]) == 2 and not dist.is_initialized()
    assert "--device cpu" in capsys.readouterr().err
