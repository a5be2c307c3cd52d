"""Where the Chamfer forward kernel's time goes (K4, csrc/chamfer_fwd.cu):
times compile-time variants of the kernel against the full one on one
CUDA card, at the main path's shape (B = 64 clouds of N = 2048 points,
f32, random normal clouds from a seed):

    python scripts/ab_chamfer_fwd.py

The variants live in scripts/ab_chamfer_fwd.cu, which includes the
package's kernel source; this script compiles it with nvcc into
build/ab_chamfer_fwd/ (the package's library holds no variant). They strip
one part each, as scripts/ab_chamfer_parts.py did for the TPU kernel, or
add one, as scripts/ab_chamfer_packed.py's `packed+xmin` did:

  full        the package's kernel (both packed keys, atomicMin combine)
  noarg       both sides' exact minima, no index bits (no key LOP3s)
  minp-only   d2 and the pred-side keys only
  ming-only   d2 and the gt-side keys and their combine only
  d2-only     d2 alone, folded by one xor a pair so it is not dropped
  packed+xmin the packed argmins and the exact f32 minima beside them
  no-combine  full, without the gt-side combine across CTAs (wrong output)

Each arm is one call as the package makes it (the fill of the gt-side key
row, then the launch), timed by chip_smoke.py's `_sync_ms` (CUDA events
around 10 back-to-back calls, median of 3 runs), in turns with the full
kernel first and last. Every output a variant keeps is checked bit for
bit: `full` and the kept sides of the stripped variants against the
package's `chamfer_nn_packed`, `packed+xmin`'s minima against the exact
minimum of the same d2. The first line is the card's name and power limit
(nvidia-smi).
"""

import ctypes
import os
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from chip_smoke import _sync_ms  # noqa: E402
from vae_song_tpu_torch import _kernels  # noqa: E402
from vae_song_tpu_torch.ops import chamfer  # noqa: E402

B, N, SEED = 64, 2048, 0
# the Mode enum of scripts/ab_chamfer_fwd.cu; full is vst_chamfer_nn_packed
MODES = {"full": 0, "noarg": 1, "minp-only": 2, "ming-only": 3, "d2-only": 4,
         "packed+xmin": 5, "no-combine": 6}
ORDER = ("full", "noarg", "minp-only", "ming-only", "d2-only", "packed+xmin", "no-combine",
         "full")
# outputs (minp, argp, ming, argg) each variant computes as the full kernel does
KEPT = {"full": (0, 1, 2, 3), "noarg": (0, 2), "minp-only": (0, 1), "ming-only": (2, 3),
        "d2-only": (), "packed+xmin": (1, 3), "no-combine": (0, 1)}


def _library():
    """Compile scripts/ab_chamfer_fwd.cu (with the package's flags) unless
    built for these sources, and load it."""
    src = ROOT / "scripts" / "ab_chamfer_fwd.cu"
    deps = (src, _kernels.CSRC / "chamfer_fwd.cu", _kernels.CSRC / "mma_bf16.cuh")
    stamp = max(p.stat().st_mtime_ns for p in deps)
    out = ROOT / "build" / "ab_chamfer_fwd"
    so = out / f"ab_chamfer_fwd_{stamp}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        built = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", str(so),
                                str(src)], capture_output=True, text=True, check=False)
        print(built.stdout + built.stderr, end="")
        if built.returncode != 0:
            raise SystemExit("nvcc failed for scripts/ab_chamfer_fwd.cu")
    lib = ctypes.CDLL(str(so))
    tail = (*(ctypes.c_void_p,) * 7, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    lib.vst_chamfer_nn_packed.argtypes = tail
    lib.vst_chamfer_fwd_variant.argtypes = (ctypes.c_int, *tail)
    lib.vst_chamfer_nn_packed.restype = lib.vst_chamfer_fwd_variant.restype = ctypes.c_int
    return lib


def _variant(lib, mode, pred, gt, out):
    """One call as the package makes it: the fill of the gt-side key row and
    counts (two rows for packed+xmin), then the launch."""
    rows = 2 if mode == MODES["packed+xmin"] else 1
    scratch = torch.full((B * (rows * N + 1),), 0x7FFFFFFF, dtype=torch.int32, device=pred.device)
    args = (pred.data_ptr(), gt.data_ptr(), *(t.data_ptr() for t in out), scratch.data_ptr(),
            B, N, N, torch.cuda.current_stream().cuda_stream)
    err = (lib.vst_chamfer_nn_packed(*args) if mode == MODES["full"]
           else lib.vst_chamfer_fwd_variant(mode, *args))
    if err != 0:
        raise RuntimeError(f"variant {mode}: CUDA error {err}")


def _exact_min(query, ref):
    """min_j d2_ij with the kernel's d2, no truncation, [B, Nq]."""
    out = []
    for s in range(0, query.shape[1], 256):
        dx, dy, dz = (query[:, s:s + 256, None, :] - ref[:, None, :, :]).unbind(-1)
        out.append(((dx * dx + dy * dy) + dz * dz).amin(dim=2))
    return torch.cat(out, dim=1)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    pred = torch.randn(B, N, 3, generator=gen, device=dev)
    gt = torch.randn(B, N, 3, generator=gen, device=dev)
    lib = _library()
    new = lambda: [torch.empty(B, N, device=dev, dtype=dt)
                   for dt in (torch.float32, torch.int32, torch.float32, torch.int32)]

    want = chamfer.chamfer_nn_packed(pred, gt)
    exact = (_exact_min(pred, gt), _exact_min(gt, pred))
    agree = True
    for name, mode in MODES.items():
        out = new()
        _variant(lib, mode, pred, gt, out)
        torch.cuda.synchronize()
        same = all(torch.equal(out[k], want[k]) for k in KEPT[name])
        if name == "packed+xmin":
            same = same and torch.equal(out[0], exact[0]) and torch.equal(out[2], exact[1])
        print(f"{name:12s} outputs {KEPT[name]} equal the package's kernel bitwise"
              f"{' (minima: the exact ones)' if name == 'packed+xmin' else ''}: {same}")
        agree = agree and same

    out = new()
    times = {}
    for name in ORDER:
        times.setdefault(name, []).append(
            _sync_ms(lambda: _variant(lib, MODES[name], pred, gt, out), 10))
    pairs = B * N * N
    for name in MODES:
        ms = statistics.mean(times[name])
        print(f"{name:12s} {ms:.4f} ms  ({' '.join(f'{t:.4f}' for t in times[name])}; "
              f"{pairs / ms / 1e9:.1f} Gpair/s; {ms / statistics.mean(times['full']):.3f} of full)")
    if not agree:
        raise SystemExit("a variant disagrees with the package's kernel")


if __name__ == "__main__":
    main()
