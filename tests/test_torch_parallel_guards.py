"""The port trainer's strategy guards, with the JAX trainer's conditions
and messages (JAX tests/test_trainer_tp_sp.py:107,115,139,
tests/test_fsdp.py:143), the refusal of the strategies item 15b still
holds, and FSDP on one process: `fsdp: true` without a launcher opens a
one-rank gloo group, trains as the single-device run does, and closes
the group. Nothing here starts another process."""

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
