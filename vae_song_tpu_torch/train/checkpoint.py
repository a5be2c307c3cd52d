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
    It is the port's own format. The JAX trainer's `ckpt_*.pkl` holds
    `flax.serialization.to_bytes` of its TrainState (msgpack) beside the
    epoch and `extra`; `load_checkpoint` reads that too, with the small
    msgpack reader below (`msgpack_restore`: no flax, no msgpack
    package), and resumes it through the same weight map and
    `train.state.load_optax_state`.

Writes are atomic (a `.tmp` file, then `os.replace`). Unpickling runs
code from the file, so load only files this project wrote.
"""

import os
import pickle
import queue
import struct
import sys
import threading

import numpy as np

from vae_song_tpu_torch import weights
from vae_song_tpu_torch.nn.sync import full_tensor
from vae_song_tpu_torch.train.state import TrainState, adam_state, load_optax_state


def _capture(state: TrainState, copy: bool) -> dict:
    """The tensors and numbers a checkpoint holds, where they live;
    cloned on their device when `copy`, so later in-place updates of
    the live state cannot reach them. A sharded tensor (a DTensor under
    FSDP or tensor parallelism) is gathered whole, a collective every
    rank makes, so that the file is the single-device one whatever the
    strategy."""
    def dup(t):
        t = full_tensor(t).detach()
        return t.clone() if copy else t

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


class _Reader:
    """A msgpack decoder for what `flax.serialization.to_bytes` writes:
    maps, arrays, strings, binaries, integers, floats, booleans, nil and
    the ext types under which flax stores an ndarray (1) and a numpy scalar
    (3), each itself the msgpack of (shape, dtype name, raw C-order
    bytes)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(">" + fmt)))[0]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.read()
            out[key] = self.read()
        return out

    def ext(self, code: int, n: int):
        if code not in (1, 3):
            raise ValueError(f"msgpack ext type {code} is not a flax ndarray")
        shape, dtype, raw = _Reader(self.take(n)).read()
        arr = np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy()
        return arr if code == 1 else arr[()]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I", 0xD9: "B", 0xDA: "H", 0xDB: "I"}
        if b in sized:
            raw = self.take(self.unpack(sized[b]))
            return raw if b <= 0xC6 else raw.decode()
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return [self.read() for _ in range(self.unpack("H" if b == 0xDC else "I"))]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: "B", 0xC8: "H", 0xC9: "I"}[b])
            return self.ext(self.unpack("b"), n)
        if 0xD4 <= b <= 0xD8:
            code = self.unpack("b")
            return self.ext(code, 1 << (b - 0xD4))
        raise ValueError(f"msgpack type byte {b:#04x} is not supported")


def _unchunk(tree):
    """flax stores arrays over its chunk size as {"__msgpack_chunked_array__",
    "shape", "chunks"}: put them back together."""
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = [tree["shape"][k] for k in sorted(tree["shape"], key=int)]
        chunks = [tree["chunks"][k] for k in sorted(tree["chunks"], key=int)]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The state dict that `flax.serialization.msgpack_restore` would give
    for `data`: nested dicts, numpy arrays and Python scalars."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes after the msgpack object")
    return _unchunk(tree)


def load_checkpoint(path, state: TrainState):
    """Restore a `save_checkpoint` file, or a JAX trainer's checkpoint
    (its TrainState as flax msgpack bytes), into `state` (its model and
    optimizer, on their device); returns (state, epoch, extra)."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    if isinstance(payload.get("state"), bytes):
        payload = dict(payload, **msgpack_restore(payload["state"]))
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
    state_dict = {k: full_tensor(v) for k, v in model.state_dict().items()}
    with open(path, "wb") as f:
        pickle.dump(weights.state_dict_to_variables(state_dict), f)


def load_params_only(path, model):
    """Load a `save_params_only` pickle (the port's or the JAX package's)
    into `model`, BatchNorm statistics included, and return it."""
    with open(path, "rb") as f:
        payload = pickle.load(f)
    return weights.load_flax_params(model, payload["params"], payload.get("batch_stats"))
