"""Profiling hooks (port of vae_song_tpu/train/profiling.py).

  * `trace(logdir)`: a context manager around torch.profiler over the CPU
    and, where there is one, the CUDA device, writing a trace that
    TensorBoard's profiler plugin loads (`*.pt.trace.json`) into `logdir`
    when the block ends;
  * `StepTimer`: per-step wall clock with a percentile summary;
  * `device_memory_mb()`: the memory the caching allocator holds for
    tensors on the CUDA device, 0.0 on the CPU.
"""

import contextlib
import time

import numpy as np
import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block into `logdir`. If the profiler refuses to start,
    say so and run the block unprofiled (as the JAX package's `trace`
    does); any other failure is raised."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(
        activities=activities, on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir))
    try:
        prof.start()
    except RuntimeError as e:
        print(f"torch.profiler trace unavailable: {e}")
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            prof.stop()


def _synchronize(tree):
    """Wait for the CUDA devices of the tensors in `tree` (a tensor, or
    dicts, lists and tuples of them)."""
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            torch.cuda.synchronize(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _synchronize(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _synchronize(v)


class StepTimer:
    """Per-step wall-clock statistics. Call mark() after each step, with
    the step's output to wait for its device (JAX's block_until_ready)."""

    def __init__(self, capacity: int = 10_000):
        self.capacity = capacity
        self.times = []
        self._last = None

    def start(self):
        self._last = time.perf_counter()

    def mark(self, block_on=None):
        if block_on is not None:
            _synchronize(block_on)
        now = time.perf_counter()
        if self._last is not None and len(self.times) < self.capacity:
            self.times.append(now - self._last)
        self._last = now

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.array(self.times)
        return {
            "steps": len(a),
            "mean_ms": float(a.mean() * 1e3),
            "p50_ms": float(np.percentile(a, 50) * 1e3),
            "p90_ms": float(np.percentile(a, 90) * 1e3),
            "p99_ms": float(np.percentile(a, 99) * 1e3),
            "total_s": float(a.sum()),
        }


def device_memory_mb(device=None) -> float:
    """MB allocated to tensors on `device` (the current CUDA device when
    None), torch.cuda.memory_allocated; 0.0 on the CPU or without a card,
    as the JAX package reports for a CPU run."""
    device = torch.device(device) if device is not None else None
    if (device is not None and device.type != "cuda") or not torch.cuda.is_available():
        return 0.0
    return torch.cuda.memory_allocated(device) / (1024.0 ** 2)
