"""ctypes bindings to the native host library (port of
vae_song_tpu/data/native.py, same entry points, signatures and numpy
fallbacks).

The port builds its own copy of the library from `native/vsthost.cpp`
with the flags of `native/Makefile` (`g++ -O3 -march=native -fPIC
-std=c++17 -Wall -shared`) at first use, into `build/native/` at the root
of the checkout (listed in .gitignore), named by a hash of the source and
the flags. It never loads the committed `native/libvsthost.so` (built with
-march=native on another host, it may hold instructions this host lacks)
and never writes into `native/`. Where no compiler is found or the build
fails, every entry point takes its numpy fallback, as in JAX, and
`available()` is False.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCE = ROOT / "native" / "vsthost.cpp"
BUILD_DIR = ROOT / "build" / "native"
# native/Makefile's CXXFLAGS, and -shared
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

_lock = threading.Lock()
_lib = None
_tried = False
# batches the native loader handed out (NativeBatchLoader's native path):
# a run that asked for native_prefetch can show that it took the loader
loader_batches = 0


def library_path() -> Path:
    """Path of the library for the current source and flags (built or not)."""
    h = hashlib.sha256(" ".join(CXXFLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvsthost_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/vsthost.cpp unless the library for this source
    exists; written to a temporary name and renamed, so processes that
    build at once never load a half-written file."""
    so = library_path()
    if so.exists():
        return so
    cxx = shutil.which(os.environ.get("CXX", "g++"))
    if cxx is None:
        raise RuntimeError("no C++ compiler (g++) on PATH")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        subprocess.run([cxx, *CXXFLAGS, "-o", tmp, str(SOURCE)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(build()))
            lib.resample_point_clouds.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.POINTER(ctypes.c_int64), ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_float),
            ]
            lib.shuffled_gather.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
            ]
            lib.make_permutation.argtypes = [
                ctypes.c_int64, ctypes.c_uint64, ctypes.POINTER(ctypes.c_int64),
            ]
            lib.chamfer_cpu.argtypes = [
                ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ]
            lib.chamfer_cpu.restype = ctypes.c_double
            u8p = ctypes.POINTER(ctypes.c_uint8)
            lib.loader_create.argtypes = [
                u8p, u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_uint64,
                ctypes.c_int64, ctypes.c_int64,
            ]
            lib.loader_create.restype = ctypes.c_void_p
            lib.loader_num_batches.argtypes = [ctypes.c_void_p]
            lib.loader_num_batches.restype = ctypes.c_int64
            lib.loader_next.argtypes = [ctypes.c_void_p, u8p, u8p]
            lib.loader_next.restype = ctypes.c_int
            lib.loader_destroy.argtypes = [ctypes.c_void_p]
            _lib = lib
        except Exception as e:  # no toolchain -> numpy fallbacks
            print(f"native vsthost unavailable ({e}); using numpy fallbacks")
            _lib = None
        return _lib


def available() -> bool:
    return _load() is not None


def _fptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def resample_point_clouds(clouds, target: int, seed: int = 0):
    """Resample a list of [n_i, dim] float32 arrays to [len, target, dim]:
    the library's mt19937_64 stream, or without it one numpy Generator."""
    lib = _load()
    dim = clouds[0].shape[1]
    if lib is None:
        rng = np.random.default_rng(seed)
        out = np.empty((len(clouds), target, dim), np.float32)
        for i, pts in enumerate(clouds):
            n = pts.shape[0]
            if n == target:
                out[i] = pts
            elif n > target:
                out[i] = pts[rng.choice(n, target, replace=False)]
            else:
                idx = rng.choice(n, target - n, replace=True)
                out[i] = np.concatenate([pts, pts[idx]], axis=0)
        return out
    flat = np.ascontiguousarray(np.concatenate(clouds, axis=0), np.float32)
    counts = np.array([c.shape[0] for c in clouds], np.int64)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int64)
    out = np.empty((len(clouds), target, dim), np.float32)
    lib.resample_point_clouds(
        _fptr(flat), _iptr(offsets), _iptr(counts),
        len(clouds), dim, target, seed, _fptr(out),
    )
    return out


def shuffled_gather(data, perm):
    """out[i] = data[perm[i]], contiguous batch assembly."""
    lib = _load()
    data = np.ascontiguousarray(data, np.float32)
    if lib is None:
        return data[perm]
    perm = np.ascontiguousarray(perm, np.int64)
    rows = perm.shape[0]
    row_elems = int(np.prod(data.shape[1:]))
    out = np.empty((rows, *data.shape[1:]), np.float32)
    lib.shuffled_gather(_fptr(data), _iptr(perm), rows, row_elems, _fptr(out))
    return out


def make_permutation(n: int, seed: int = 0):
    lib = _load()
    if lib is None:
        return np.random.default_rng(seed).permutation(n).astype(np.int64)
    out = np.empty(n, np.int64)
    lib.make_permutation(n, seed, _iptr(out))
    return out


class NativeBatchLoader:
    """Threaded prefetch batch loader (the library's loader_* entry
    points), the equivalent of the reference's DataLoader(num_workers=8,
    pin_memory, drop_last) (main.py:182-197): C++ worker threads gather
    shuffled contiguous batches into a bounded ring ahead of the consumer.

    Iterates one epoch of (x, y) numpy batches; deterministic for a given
    seed. The native path shuffles with the library's mt19937_64
    Fisher-Yates (`make_permutation`), the numpy fallback with a numpy
    permutation: both are seed-deterministic, but their orders differ.
    Single consumer; drop_last always."""

    def __init__(self, X, y=None, batch_size: int = 1, shuffle: bool = True,
                 seed: int = 0, n_workers: int = 2, depth: int = 4):
        self.X = np.ascontiguousarray(X)
        self.y = np.ascontiguousarray(y) if y is not None else None
        self.batch = int(batch_size)
        self.n_batches = len(self.X) // self.batch
        self._shuffle = shuffle
        self._seed = seed
        self._nw = n_workers
        self._depth = depth
        self._lib = _load()

    def __len__(self):
        return self.n_batches

    def _u8(self, a):
        return a.view(np.uint8).reshape(len(a), -1) if a is not None else None

    def __iter__(self):
        global loader_batches
        if self._lib is None:
            perm = (
                np.random.default_rng(self._seed).permutation(len(self.X))
                if self._shuffle else np.arange(len(self.X))
            )
            for b in range(self.n_batches):
                sel = perm[b * self.batch:(b + 1) * self.batch]
                yield self.X[sel], (self.y[sel] if self.y is not None else None)
            return

        u8p = ctypes.POINTER(ctypes.c_uint8)
        Xb = self._u8(self.X)
        Yb = self._u8(self.y)
        x_row = Xb.shape[1]
        y_row = Yb.shape[1] if Yb is not None else 0
        h = self._lib.loader_create(
            Xb.ctypes.data_as(u8p),
            Yb.ctypes.data_as(u8p) if Yb is not None else None,
            len(self.X), x_row, y_row, self.batch, 1,
            1 if self._shuffle else 0, self._seed, self._nw, self._depth,
        )
        try:
            ox = np.empty((self.batch, x_row), np.uint8)
            oy = np.empty((self.batch, max(y_row, 1)), np.uint8)
            for _ in range(self.n_batches):
                ok = self._lib.loader_next(h, ox.ctypes.data_as(u8p), oy.ctypes.data_as(u8p))
                if not ok:
                    break
                loader_batches += 1
                x = ox.view(self.X.dtype).reshape((self.batch,) + self.X.shape[1:]).copy()
                yv = None
                if self.y is not None:
                    yv = oy[:, :y_row].view(self.y.dtype).reshape(
                        (self.batch,) + self.y.shape[1:]).copy()
                yield x, yv
        finally:
            self._lib.loader_destroy(h)


def chamfer_cpu(pred, gt) -> float:
    """Reference CPU Chamfer distance (an oracle for the kernels)."""
    lib = _load()
    pred = np.ascontiguousarray(pred, np.float32)
    gt = np.ascontiguousarray(gt, np.float32)
    if lib is None:
        d2 = ((pred[:, :, None, :] - gt[:, None, :, :]) ** 2).sum(-1)
        return float((d2.min(2).mean(1) + d2.min(1).mean(1)).mean())
    b, np_, _ = pred.shape
    ng = gt.shape[1]
    return float(lib.chamfer_cpu(_fptr(pred), _fptr(gt), b, np_, ng))
