"""Checkpoints and parameter exports (port of
vae_song_tpu/train/checkpoint.py: save_checkpoint, load_checkpoint,
AsyncCheckpointer, save_params_only and load_params_only).

Every file is a plain pickle of numpy trees in the Flax layout, written
and read without jax or flax through vae_song_tpu_torch.weights, the one
map between the port's state_dict and the JAX package's variables:

  * `save_params_only` writes `params/model_{epoch}.pkl` as the JAX
    trainer does: {"params", "batch_stats"} (the DeepSets models' BatchNorm
    statistics; {} for the attention models, which keep none). A JAX
    export loads into the port, and a port export into the JAX package.
  * `save_checkpoint` writes `params/ckpt_{epoch}.pkl`: params,
    batch_stats, the Adam moments and count in optax's ScaleByAdamState
    layout, the train step, the epoch and `extra` (the warmup state).
    It is the port's own format: the JAX trainer's `ckpt_*.pkl` holds
    `flax.serialization.to_bytes` of its TrainState (msgpack), which
    the port cannot decode without flax; `load_checkpoint` recognises
    that payload and raises. A JAX TrainState that is at hand in Python
    carries across through `train.state.load_optax_state`.

Writes are atomic (a `.tmp` file, then `os.replace`). Unpickling runs
code from the file, so load only files this project wrote.
"""

import os
import pickle
import queue
import sys
import threading

import numpy as np

from vae_song_tpu_torch import weights
from vae_song_tpu_torch.train.state import TrainState, adam_state, load_optax_state


def _capture(state: TrainState, copy: bool) -> dict:
    """The tensors and numbers a checkpoint holds, where they live;
    cloned on their device when `copy`, so later in-place updates of
    the live state cannot reach them."""
    dup = (lambda t: t.detach().clone()) if copy else (lambda t: t.detach())
    adam = adam_state(state)
    return {"model": {k: dup(v) for k, v in state.model.state_dict().items()},
            "mu": {k: dup(v) for k, v in adam["mu"].items()},
            "nu": {k: dup(v) for k, v in adam["nu"].items()},
            "count": adam["count"], "step": state.step}


def _write(path, snap: dict, epoch: int, extra: dict | None):
    """Copy a capture to the host and write it atomically."""
    variables = weights.state_dict_to_variables(snap["model"])
    payload = {
        "params": variables["params"],
        "batch_stats": variables["batch_stats"],
        "opt_state": {"count": np.int32(snap["count"]),
                      "mu": weights.state_dict_to_params(snap["mu"]),
                      "nu": weights.state_dict_to_params(snap["nu"])},
        "step": int(snap["step"]),
        "epoch": epoch,
        "extra": extra or {},
    }
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f)
    os.replace(tmp, path)


def save_checkpoint(path, state: TrainState, epoch: int = 0, extra: dict | None = None):
    """Write the full train state (parameters, BatchNorm statistics, Adam
    moments and count, step), `epoch` and `extra` to `path`."""
    _write(path, _capture(state, copy=False), epoch, extra)


def load_checkpoint(path, state: TrainState):
    """Restore a `save_checkpoint` file into `state` (its model and
    optimizer, on their device); returns (state, epoch, extra). A JAX
    trainer checkpoint (flax msgpack) raises ValueError."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if isinstance(payload.get("state"), bytes):
        raise ValueError(
            f"{path} is a JAX trainer checkpoint (flax.serialization msgpack bytes), "
            "which the PyTorch port cannot decode without flax; resume it with the JAX "
            "package, or carry its TrainState across with "
            "vae_song_tpu_torch.train.state.load_optax_state (ROADMAP.md Queue 1)"
        )
    weights.load_flax_params(state.model, payload["params"], payload["batch_stats"])
    load_optax_state(state, payload["opt_state"], payload["step"])
    return state, payload["epoch"], payload.get("extra", {})


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (the JAX package's
    contract).

    `submit()` snapshots the state on its device (`clone`, enqueued on
    the current stream, so the next optimizer step's in-place updates
    cannot reach the queued state) and one worker thread copies the
    snapshot to the host and writes it. Writes land in submission order.
    `wait()` blocks until the queue drains and re-raises the first
    worker error. `submit()` never raises for an earlier write failure:
    a missing periodic snapshot must not abort the run it protects; it
    warns once per error and keeps submitting.
    """

    def __init__(self):
        self._q: queue.Queue = queue.Queue()
        self._err: list[BaseException] = []
        self._warned = 0
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    def submit(self, path, state: TrainState, epoch: int = 0,
               extra: dict | None = None) -> None:
        while self._warned < len(self._err):
            print(
                "WARNING: async checkpoint write failed: "
                f"{self._err[self._warned]!r} (training continues; that "
                "periodic snapshot is missing)",
                file=sys.stderr, flush=True,
            )
            self._warned += 1
        self._q.put((path, _capture(state, copy=True), epoch, extra))

    def _run(self):
        while True:
            item = self._q.get()
            try:
                if item is None:
                    return
                _write(*item)
            except Exception as e:  # surfaced by wait(), close() and submit()
                self._err.append(e)
            finally:
                self._q.task_done()

    def wait(self) -> None:
        self._q.join()
        if self._err:
            raise self._err[0]

    def close(self) -> None:
        """Drain the queue and stop the worker unconditionally (the
        shutdown sentinel goes in before any error is re-raised, so a
        failed write never leaks the thread); then surface the first
        worker error."""
        self._q.join()
        self._q.put(None)
        self._worker.join()
        if self._err:
            raise self._err[0]


def save_params_only(path, model):
    """Write `model`'s variables as the JAX package's `save_params_only`
    does: {"params", "batch_stats"}, Flax trees of float32 numpy arrays."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        pickle.dump(weights.state_dict_to_variables(model.state_dict()), f)


def load_params_only(path, model):
    """Load a `save_params_only` pickle (the port's or the JAX package's)
    into `model`, BatchNorm statistics included, and return it."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return weights.load_flax_params(model, payload["params"], payload.get("batch_stats"))
