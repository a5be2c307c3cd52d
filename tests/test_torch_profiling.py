"""train/profiling.py in the port (torch.profiler) against the JAX
package's (vae_song_tpu/train/profiling.py), and `train_and_test`'s
`profile_dir`, on the CPU."""

import glob
import json
import os
import time

import torch

from vae_song_tpu.train import profiling as jax_profiling
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.train import profiling
from vae_song_tpu_torch.train.loop import train_and_test


def _traces(root):
    return glob.glob(os.path.join(str(root), "**", "*.pt.trace.json"), recursive=True)


def test_step_timer_keys_are_jax():
    """The same summary keys after the same marks; the port's mark takes
    a step's output and waits for its device (a CPU tensor: nothing to
    wait for)."""
    timers = (profiling.StepTimer(), jax_profiling.StepTimer())
    for t in timers:
        assert t.summary() == {}
        t.start()
        for _ in range(3):
            time.sleep(0.001)
            t.mark()
    timers[0].mark({"loss": torch.ones(()), "terms": [torch.zeros(2)]})
    got, want = (t.summary() for t in timers)
    assert list(got) == list(want)
    assert got["steps"] == 4 and want["steps"] == 3 and got["p50_ms"] >= 1.0


def test_device_memory_is_zero_on_the_cpu():
    """As the JAX package's forced-CPU branch (its :92-95)."""
    assert profiling.device_memory_mb("cpu") == 0.0 == jax_profiling.device_memory_mb()
    if not torch.cuda.is_available():
        assert profiling.device_memory_mb() == 0.0


def test_trace_writes_a_tensorboard_trace(tmp_path):
    with profiling.trace(str(tmp_path)):
        torch.randn(64, 64) @ torch.randn(64, 64)
    (path,) = _traces(tmp_path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any("mm" in e.get("name", "") for e in events)


def test_trace_goes_on_when_the_profiler_refuses(tmp_path, monkeypatch, capsys):
    """A profiler that will not start is reported and the block runs
    unprofiled, as JAX's trace does; nothing is written."""
    def refuse(self):
        raise RuntimeError("profiler busy")

    monkeypatch.setattr(torch.profiler.profile, "start", refuse)
    ran = []
    with profiling.trace(str(tmp_path)):
        ran.append(True)
    assert ran and "torch.profiler trace unavailable: profiler busy" in capsys.readouterr().out
    assert not _traces(tmp_path)


def test_train_and_test_traces_epoch_1(tmp_path):
    """`profile_dir` traces epoch 1's train steps (JAX train/loop.py:819-887):
    one trace, holding the steps' ops; a run of one epoch writes none."""
    kw = dict(batch_size=8, dataset_name="shapenet", device="cpu", progress=False,
              visualize_artifacts=False,
              dataset_params={"fake": True, "num_points": 16, "num_samples": 16})
    mp = dict(latent_channel=4, num_points=16, d_model=16, num_heads=2, ff_dim=32)
    train_and_test(build_model("setvae", "shapenet", mp), epochs=2,
                   profile_dir=str(tmp_path / "prof"), output_root=str(tmp_path / "a"), **kw)
    (path,) = _traces(tmp_path / "prof")
    with open(path) as f:
        names = {e.get("name", "") for e in json.load(f)["traceEvents"]}
    assert any("addmm" in n or "matmul" in n for n in names)
    train_and_test(build_model("setvae", "shapenet", mp), epochs=1,
                   profile_dir=str(tmp_path / "prof1"), output_root=str(tmp_path / "b"), **kw)
    assert not _traces(tmp_path / "prof1")
