"""Native TensorBoard event-file writer (port of
vae_song_tpu/train/tfevents.py, copied: importing it would pull in jax
through vae_song_tpu/train/__init__.py). No tensorboard or tensorflow
dependency: a tfevents file is just a TFRecord stream of
serialized `Event` protos, and the scalar-only subset the framework
needs (tag + simple_value per step) is ~40 bytes of hand-rolled proto
per event:

  Event    { 1: double wall_time; 2: int64 step;
             3: string file_version; 5: Summary summary }
  Summary  { 1: repeated Value value }
  Value    { 1: string tag; 2: float simple_value }

TFRecord framing: <uint64 len LE> <uint32 masked-crc32c(len)> <data>
<uint32 masked-crc32c(data)>, with the Castagnoli CRC and TF's mask
rotation. TensorBoard's own event_file_loader parses the output
(tests/test_tfevents.py checks the JAX package's copy through it when
the tensorboard package is present).
"""

import os
import socket
import struct
import time

# ---- CRC32C (Castagnoli), table-driven ------------------------------

_CRC_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ (0x82F63B78 if _c & 1 else 0)
    _CRC_TABLE.append(_c)


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for b in data:
        crc = (crc >> 8) ^ _CRC_TABLE[(crc ^ b) & 0xFF]
    return crc ^ 0xFFFFFFFF


def _masked_crc(data: bytes) -> int:
    crc = _crc32c(data)
    return (((crc >> 15) | (crc << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# ---- minimal proto encoding -----------------------------------------

def _varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _field_double(num: int, value: float) -> bytes:
    return _varint(num << 3 | 1) + struct.pack("<d", value)


def _field_varint(num: int, value: int) -> bytes:
    return _varint(num << 3 | 0) + _varint(value)


def _field_bytes(num: int, value: bytes) -> bytes:
    return _varint(num << 3 | 2) + _varint(len(value)) + value


def _field_float(num: int, value: float) -> bytes:
    return _varint(num << 3 | 5) + struct.pack("<f", value)


def _scalar_event(tag: str, value: float, step: int, wall_time: float) -> bytes:
    v = _field_bytes(1, tag.encode()) + _field_float(2, float(value))
    summary = _field_bytes(1, v)
    return (
        _field_double(1, wall_time)
        + _field_varint(2, int(step))
        + _field_bytes(5, summary)
    )


def _version_event(wall_time: float) -> bytes:
    return _field_double(1, wall_time) + _field_bytes(3, b"brain.Event:2")


def _record(data: bytes) -> bytes:
    header = struct.pack("<Q", len(data))
    return (
        header
        + struct.pack("<I", _masked_crc(header))
        + data
        + struct.pack("<I", _masked_crc(data))
    )


class EventFileWriter:
    """Scalar-only tfevents writer, API-compatible with the subset of
    SummaryWriter the training loop uses."""

    def __init__(self, log_dir):
        os.makedirs(log_dir, exist_ok=True)
        t = time.time()
        fname = f"events.out.tfevents.{int(t)}.{socket.gethostname()}"
        self.path = os.path.join(log_dir, fname)
        self._f = open(self.path, "ab")
        self._f.write(_record(_version_event(t)))
        self._f.flush()

    def add_scalar(self, tag, value, step):
        self._f.write(_record(_scalar_event(tag, float(value), step, time.time())))
        # flush every record: scalars arrive a handful per EPOCH, so
        # this costs nothing, and a killed multi-hour run keeps its
        # curve (torch's SummaryWriter flushes every ~120 s; buffering
        # until close() would lose everything on SIGKILL)
        self._f.flush()

    def flush(self):
        self._f.flush()

    def close(self):
        if self._f is not None:
            self._f.flush()
            self._f.close()
            self._f = None
