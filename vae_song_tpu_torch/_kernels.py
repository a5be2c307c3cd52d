"""Build, load and launch the port's CUDA kernels.

At first use, `nvcc` compiles every source under `csrc/` for Hopper
(sm_90a), one compiler process per `.cu` file, all started together,
then links the objects into one shared library with a plain C interface,
which ctypes loads. The library lands in `build/cuda/` at the root of the checkout
(listed in .gitignore), named by a hash of the sources and flags, so an
edited source rebuilds and an unchanged one loads the cached file.
Nothing builds at import time: the CPU tests import every module of the
package on machines without nvcc or a GPU.

Each C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `launch` raises if that is not 0, so a launch the
card refuses (too many threads, too much shared memory, wrong
architecture) fails where it happened.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

from vae_song_tpu_torch.nn.sync import is_dtensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "cuda"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every C entry point: pointers and the stream as c_void_p,
# so ctypes never narrows them to 32 bits
_SIGNATURES = {
    "vst_dense_attn_fwd": (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _F, _P),
    "vst_dense_attn_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _L, _L, _L, _L, _L, _L, _F, _F, _P),
    "vst_chamfer_nn_packed": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "vst_chamfer_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "vst_ffn_fwd": (_I, _P, _P, _P, _P, _P, _P, _L, _I, _I, _P),
    "vst_ffn_bwd": (_I, *(_P,) * 16, _L, _I, _I, _I, _P),
    "vst_dense_attn_cluster_fit": (_I, _P, _P),
}

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found on PATH or in /usr/local/cuda/bin")
    return found


def _sources():
    return sorted(p for p in CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def library_path() -> Path:
    """Path of the library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libvst_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/ unless the library for these sources exists: one
    `nvcc -c` per `.cu` file, run in parallel, then one link. The
    compilers' output, ptxas register and shared-memory counts included,
    is kept in build/cuda/build.log."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    nvcc = _nvcc()
    cus = [p for p in _sources() if p.suffix == ".cu"]
    objs = [BUILD_DIR / f"{tag}.{p.stem}.o" for p in cus]
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(cu)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for cu, obj in zip(cus, objs)
    ]
    logs, failed = [], []
    for cu, proc in zip(cus, procs):
        out, _ = proc.communicate()
        logs.append(f"== {cu.name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(cu.name)
    tmp = so.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
             *map(str, objs)],
            capture_output=True, text=True, check=False,
        )
        logs.append(f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log[-6000:]}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.vst_cuda_error_string.argtypes = (ctypes.c_int,)
            lib.vst_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


@functools.lru_cache(maxsize=None)
def _capability(index: int):
    return torch.cuda.get_device_capability(index)


def check_device(t: torch.Tensor) -> None:
    """Raise unless `t` is a plain tensor on a Hopper card the library was
    built for: a DTensor (a sharded parameter or activation) has no one
    device pointer to hand the kernel."""
    if is_dtensor(t):
        raise TypeError("a DTensor reached a kernel wrapper; the kernels take its "
                        "local tensor (DTensor.to_local())")
    if t.device.type != "cuda":
        raise ValueError(f"expected a CUDA tensor, got one on {t.device}")
    cap = _capability(t.device.index if t.device.index is not None
                      else torch.cuda.current_device())
    if cap != (9, 0):
        raise RuntimeError(
            f"the kernels are built for sm_90a (Hopper); {t.device} is sm_{cap[0]}{cap[1]}"
        )


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream (appended as
    the last argument) and raise if the launch reported an error. The
    device becomes the current one for the call only if it is not already
    (a short kernel's call is mostly this host path)."""
    lib = _lib or library()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    if index == current:
        err = getattr(lib, name)(*args, stream)
    else:
        with torch.cuda.device(index):
            err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.vst_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} ({msg})")
