"""The A/B arms of the bf16 packed attention at D = 64 (K1, the forward;
K2, the backward): the H100 ports of the TPU ablation kernels of
scripts/ab_attn_ablate*.py and scripts/ab_attn_bwd.py, as compile-time
arms of the package's wgmma kernels, and the harness that checks and
times them on one CUDA card:

    python scripts/ab_attn_arms.py [ROOT] [--compare PARENT]

The arms are hooks of csrc/dense_attn_fwd.cu (FwdArm) and
csrc/dense_attn_bwd.cu (BwdArm), instantiated in scripts/ab_attn_arms.cu,
which this module compiles with nvcc (sm_90a) at first use into
build/ab_attn_arms/ (the package's library holds no arm):

  K2, exact (each with a plain PyTorch version below, `BWD_PLAIN`):
    dfuse      -bf16(delta) rides the dP products (ab_attn_ablate8.py:139)
    lfuse      LSE2 as hi and lo bf16 columns rides the S products (same)
    bfuse      both (same)
    fused-e16  both, delta as hi and lo too (ab_attn_bwd.py:113)
    fused-e32  as fused-e16, exp2 in f32 (same)
  K2, strips (timing only; the outputs a strip keeps, `BWD_KEPT`, are
  checked bit for bit against the package's kernels; ab_attn_ablate.py:106):
    noexp (keeps none), nodp, nodsmul, nodq, nodk
  K1, exact: bf16max, the row max and shift on bf16-rounded scores
    (ab_attn_ablate5.py:101; plain version `fwd_bf16max_plain`)
  K1, strips (timing only; ab_attn_ablate6.py:78): noexp, nomax, sonly
    (keep none), nopv (keeps LSE2, `FWD_KEPT`, checked bit for bit)
  K1 at 64 or 128 queries a block: nc1, nc2 (ab_attn_ablate7.py:28), the
    package's kernel at a forced NC, bit for bit the package's output.
  K2 in blocks of 64 resident rows, one consumer warpgroup: rows64
    (ab_attn_ablate5.py:45), bit for bit the package's output.

`attn_bwd_arm` and `attn_fwd_arm` launch an arm on CUDA tensors (each
counting its launches in `bwd_launches` / `fwd_launches`) and take the
arm's plain version on CPU tensors. This module imports neither jax nor
the JAX package, and nothing of CUDA until a launch.

The harness (ROOT, default this checkout, is put first on sys.path and
its chip_smoke.py supplies the timing and the bounds): the card's name and
power limit; at the SetVAE main path's shape (B = 64, N = 2048, H = 4,
D = 64, bf16, q, k, v views of [B, N, H D]) and at the decoder's
batch-constant B = 1, every arm checked and timed by chip_smoke.py's
`_sync_ms` (runs of 10 calls, median of 3) with the package's kernel
first and last, beside the plain version, the bound, SDPA's call and
the tensor-core operations executed; then the SetVAE
bf16 B = 64 train step (configs/config_shapenet_setvae.yaml) with the
package's K2 and with each exact K2 arm put in place of
`denseattn._launch_bwd` in this process, in the order package, arm, arm,
package (median of 5 steps after 2 warm-ups, host clock, each ending in
a scalar fetch), with the loss terms, and the eval step likewise for K1
bf16max (`denseattn._launch_fwd`); then, as a control of how far rounding
alone moves the loss terms, 7 train steps with the package's plain
backward in place of its kernel; last, after every timed run, the device
time of each kernel every arm launches (torch.profiler).

With --compare PARENT (a checkout of the parent commit) it first compiles
the two checkouts' csrc/dense_attn_fwd.cu and dense_attn_bwd.cu (the
package's flags, one nvcc each, all at once) and compares every kernel of
both objects (K1 and K2 at every head width among them): ptxas's register
and spill lines, and the SASS (cuobjdump -sass, addresses and encodings
left out), which must be the same instructions.
"""

import collections
import contextlib
import ctypes
import functools
import hashlib
import importlib.util
import math
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path
from unittest import mock

_ARGV = sys.argv[1:] if __name__ == "__main__" else []
_PARENT = _ARGV[_ARGV.index("--compare") + 1] if "--compare" in _ARGV else None
_ROOTS = [a for a in _ARGV if not a.startswith("--") and a != _PARENT]
ROOT = Path(_ROOTS[0] if _ROOTS else Path(__file__).resolve().parent.parent).resolve()
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from vae_song_tpu_torch import _kernels  # noqa: E402
from vae_song_tpu_torch.ops import denseattn  # noqa: E402

SRC = ROOT / "scripts" / "ab_attn_arms.cu"
BUILD_DIR = ROOT / "build" / "ab_attn_arms"
# the package's sources the included ones call (the f32 kernels, the bf16
# kernels above 2048), linked into the library too
DEPS = ("dense_attn_scores.cu", "dense_attn_tf32.cu", "dense_attn_tf32_wide.cu")

# the SetVAE main path's attention shape (B = 64 or 1), and the steps of
# each in-step run after its 2 warm-ups
N, H, STEPS = 2048, 4, 5
# BwdArm and FwdArm of the package's sources; the forward's nc arms are
# the package's kernel (arm 0) at a forced number of consumer warpgroups
BWD_ARMS = {"dfuse": 1, "lfuse": 2, "bfuse": 3, "fused-e16": 4, "fused-e32": 5,
            "noexp": 6, "nodp": 7, "nodsmul": 8, "nodq": 9, "nodk": 10, "rows64": 11}
FWD_ARMS = {"bf16max": (1, 0), "noexp": (2, 0), "nomax": (3, 0), "nopv": (4, 0),
            "sonly": (5, 0), "nc1": (0, 1), "nc2": (0, 2)}
FOLD_LSE = ("lfuse", "bfuse", "fused-e16", "fused-e32")
FOLD_DELTA = ("dfuse", "bfuse", "fused-e16", "fused-e32")
BWD_EXACT = ("dfuse", "lfuse", "bfuse", "fused-e16", "fused-e32")
# the outputs (dq, dk, dv) a K2 strip computes as the package's kernels do
BWD_KEPT = {"noexp": (), "nodp": (2,), "nodsmul": (2,), "nodq": (1, 2), "nodk": (0, 2)}
# ... and the outputs (o, lse) a K1 strip computes as the package's kernel
# does (nopv runs the softmax unchanged)
FWD_KEPT = {"noexp": (), "nomax": (), "nopv": (1,), "sonly": ()}
FWD_EXACT = ("bf16max", "nc1", "nc2")
# arms that compute the package's function in another block shape: its
# bits, which the checks hold them to
SAME_AS_PACKAGE = ("rows64", "nc1", "nc2")
# the TPU function each family of arms ports (file:line of the function
# that reaches pl.pallas_call)
FAMILIES = (
    ("dense_attn_bwd_fold", "scripts/ab_attn_ablate8.py:139", "bwd", ("dfuse", "lfuse", "bfuse")),
    ("dense_attn_bwd_fused", "scripts/ab_attn_bwd.py:113", "bwd", ("fused-e16", "fused-e32")),
    ("dense_attn_bwd_strip", "scripts/ab_attn_ablate.py:106", "bwd",
     ("noexp", "nodp", "nodsmul", "nodq", "nodk")),
    ("dense_attn_fwd_bf16max", "scripts/ab_attn_ablate5.py:101", "fwd", ("bf16max",)),
    ("dense_attn_fwd_strip", "scripts/ab_attn_ablate6.py:78", "fwd",
     ("noexp", "nomax", "nopv", "sonly")),
    ("dense_attn_fwd_nc", "scripts/ab_attn_ablate7.py:28", "fwd", ("nc1", "nc2")),
    ("dense_attn_bwd_rows", "scripts/ab_attn_ablate5.py:45", "bwd", ("rows64",)),
)
# Products a call executes, in B H N^2 D (one product of depth D is 2 B H
# N^2 D operations): the package's backward computes S and dP in both of
# its kernels, 14; a fold adds a 16-deep step to S or dP in both (1 each
# at D = 64); the forward, S and P V, 4
BWD_EXECUTED = {"full": 14, "dfuse": 15, "lfuse": 15, "bfuse": 16, "fused-e16": 16,
                "fused-e32": 16, "noexp": 14, "nodp": 10, "nodsmul": 14, "nodq": 12, "nodk": 12,
                "rows64": 14}
FWD_EXECUTED = {"full": 4, "bf16max": 4, "noexp": 4, "nomax": 4, "nopv": 2, "sonly": 2,
                "nc1": 4, "nc2": 4}
# ... and the products the function an arm computes needs: S, dP, dV, dQ,
# dK (10), less those a strip drops; the forward S and P V (4)
BWD_NEEDED = {"nodp": 8, "nodq": 8, "nodk": 8}
FWD_NEEDED = {"nopv": 2, "sonly": 2}

bwd_launches = {name: 0 for name in BWD_ARMS}
fwd_launches = {name: 0 for name in FWD_ARMS}

_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
_SIGNATURES = {
    "vst_attn_arm_fwd": (_I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _P),
    "vst_attn_arm_bwd": (_I, *(_P,) * 13, _I, _I, _I, _L, _L, _L, _L, _L, _L, _F, _F, _P),
}
_lib = None


# ---- plain versions -----------------------------------------------------------

def _rd(t, dt):
    """Round to dt, back in f32."""
    return t.to(dt).float()


def bwd_fold_plain(arm, q, k, v, o, lse, do, scale: float):
    """Plain PyTorch version of K2's exact arm `arm` (BWD_EXACT): the
    package's backward (denseattn.dense_attention_bwd_plain) with the row
    constants subtracted in f32 before the rounding that follows them
    (the fold rides the f32 accumulator of the product):
      LSE2 folded (lfuse, bfuse, fused-*): P = bf16(exp2(bf16(S - (hi + lo))))
        with hi = bf16(LSE2), lo = bf16(LSE2 - hi); fused-e32: exp2 in f32,
        P = bf16(exp2(S - (hi + lo)));
      delta folded: dS = bf16(P bf16(dP - bf16(delta))) (dfuse, bfuse) or,
        delta as hi and lo of the unrounded f32 row sum, bf16(P bf16(dP -
        (hi + lo))) (fused-*);
    where not folded, the package's P = bf16(exp2(bf16(S - LSE2))) and dS =
    bf16(P bf16(bf16(dP) - bf16(delta))). q, k, v, o, do [B, N, H, D]
    bf16, lse [B, H, N] f32. Returns (dq, dk, dv) [B, N, H, D] bf16."""
    if arm not in BWD_EXACT:
        raise ValueError(f"no plain version of K2 arm {arm!r} (exact arms: {BWD_EXACT})")
    denseattn._check(q, k, v)
    dt = q.dtype
    rd = functools.partial(_rd, dt=dt)
    qc = (q.float() * (scale * denseattn.LOG2E)).to(dt)
    delta = (do.float() * o.float()).sum(dim=-1).permute(0, 2, 1)      # [B, H, N] f32
    if arm in FOLD_LSE:
        hi = rd(lse)
        shift = hi + rd(lse - hi)
    if arm in FOLD_DELTA:
        dhi = rd(delta)
        dshift = dhi + rd(delta - dhi) if arm.startswith("fused") else dhi
    dqs, dks, dvs = [], [], []
    for s0 in range(0, q.shape[0], denseattn._PLAIN_BATCH_CHUNK):
        sl = slice(s0, s0 + denseattn._PLAIN_BATCH_CHUNK)
        qf, kf, vf, dof = qc[sl].float(), k[sl].float(), v[sl].float(), do[sl].float()
        s = torch.einsum("bqhd,bkhd->bhqk", qf, kf)
        if arm == "fused-e32":
            p = rd(torch.exp2(s - shift[sl][..., None]))
        elif arm in FOLD_LSE:
            p = rd(torch.exp2(rd(s - shift[sl][..., None])))
        else:
            p = rd(torch.exp2(rd(s - lse[sl][..., None])))
        dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
        if arm in FOLD_DELTA:
            ds = rd(p * rd(dp - dshift[sl][..., None]))
        else:
            ds = rd(p * rd(rd(dp) - rd(delta[sl])[..., None]))
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dof).to(dt))
        dqs.append((torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale).to(dt))
        dks.append((torch.einsum("bhqk,bqhd->bkhd", ds, qf) * denseattn.LN2).to(dt))
    return torch.cat(dqs), torch.cat(dks), torch.cat(dvs)


def fwd_bf16max_plain(q, k, v, scale: float):
    """Plain PyTorch version of K1's exact arm bf16max: the package's
    forward with the scores rounded to bf16 before the whole-row max, m =
    max(bf16(S2)), P = bf16(exp2(bf16(bf16(S2) - m))), O = P v / rowsum(P)
    (f32 sum of the rounded P), LSE2 = m + log2(rowsum(P)). Returns (o
    [B, N, H, D] in q's dtype, lse [B, H, N] f32)."""
    denseattn._check(q, k, v)
    dt = q.dtype
    rd = functools.partial(_rd, dt=dt)
    qc = (q.float() * (scale * denseattn.LOG2E)).to(dt)
    outs, lses = [], []
    for s0 in range(0, q.shape[0], denseattn._PLAIN_BATCH_CHUNK):
        sl = slice(s0, s0 + denseattn._PLAIN_BATCH_CHUNK)
        s = rd(torch.einsum("bqhd,bkhd->bhqk", qc[sl].float(), k[sl].float()))
        m = s.amax(dim=-1, keepdim=True)
        p = rd(torch.exp2(rd(s - m)))
        o = torch.einsum("bhqk,bkhd->bqhd", p, v[sl].float())
        l = p.sum(dim=-1)
        outs.append((o / l.permute(0, 2, 1)[..., None]).to(dt))
        lses.append(m[..., 0] + torch.log2(l))
    return torch.cat(outs), torch.cat(lses)


BWD_PLAIN = {**{arm: functools.partial(bwd_fold_plain, arm) for arm in BWD_EXACT},
             "rows64": denseattn.dense_attention_bwd_plain}
FWD_PLAIN = {"bf16max": fwd_bf16max_plain, "nc1": denseattn.dense_attention_fwd_plain,
             "nc2": denseattn.dense_attention_fwd_plain}


# ---- the library ----------------------------------------------------------------

def _sources():
    return [SRC, *sorted(p for p in _kernels.CSRC.iterdir() if p.suffix in (".cu", ".cuh"))]


def library_path() -> Path:
    """The library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(_kernels.NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libab_attn_arms_{h.hexdigest()[:16]}.so"


def start_build():
    """Start the library's nvcc jobs unless it is built: the two halves of
    scripts/ab_attn_arms.cu and the package sources in DEPS, one process
    each, all at once (so they run beside the package's own build). Returns
    the handle `finish_build` takes (None when built)."""
    so = library_path()
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    units = [(SRC, ("-DVST_ARMS_FWD",), "fwd"), (SRC, (), "bwd"),
             *((_kernels.CSRC / d, (), Path(d).stem) for d in DEPS)]
    jobs = []
    for src, defs, name in units:
        obj = BUILD_DIR / f"{tag}.{name}.o"
        proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, *defs, "-c", "-o",
                                 str(obj), str(src)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, obj, proc))
    return types.SimpleNamespace(so=so, tag=tag, jobs=jobs)


def stop_build(handle):
    """Kill and reap `start_build`'s jobs (a run that fails before it
    waits for them)."""
    for _name, obj, proc in handle.jobs if handle is not None else ():
        proc.kill()
        proc.wait()
        obj.unlink(missing_ok=True)


def finish_build(handle) -> Path:
    """Wait for `start_build`'s jobs, link, and return the library's path;
    the compilers' output (ptxas's register, shared-memory and spill lines)
    goes to build/ab_attn_arms/build.log. Raises if a job failed."""
    if handle is None:
        return library_path()
    logs, failed = [], []
    for name, _obj, proc in handle.jobs:
        out, _ = proc.communicate()
        logs.append(f"== {name} (exit {proc.returncode})\n{out}")
        if proc.returncode != 0:
            failed.append(name)
    objs = [str(obj) for _name, obj, _proc in handle.jobs]
    tmp = handle.so.with_name(f"{handle.tag}.so.tmp")
    if not failed:
        link = subprocess.run([_kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                               "-shared", "-o", str(tmp), *objs],
                              capture_output=True, text=True, check=False)
        logs.append(f"== link (exit {link.returncode})\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        Path(obj).unlink(missing_ok=True)
    log = "\n".join(logs)
    (BUILD_DIR / "build.log").write_text(log)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log[-6000:]}")
    os.replace(tmp, handle.so)
    return handle.so


def library(handle=None) -> ctypes.CDLL:
    """The loaded arms library, built on first call (finishing `handle`,
    a `start_build` handle, where given)."""
    global _lib
    if _lib is None:
        so = finish_build(handle if handle is not None else start_build())
        lib = ctypes.CDLL(str(so))
        for name, argtypes in _SIGNATURES.items():
            getattr(lib, name).argtypes = argtypes
            getattr(lib, name).restype = ctypes.c_int
        lib.vst_cuda_error_string.argtypes = (ctypes.c_int,)
        lib.vst_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def ptxas_lines():
    """ptxas's lines for the arms' kernels (and every spill line) from the
    last build's log."""
    log = BUILD_DIR / "build.log"
    if not log.exists():
        return []
    lines = log.read_text().splitlines()
    keep = []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "_arm_kernel" in line:
            keep.append(" | ".join(x.strip() for x in lines[i:i + 3]))
        elif "spill" in line and "0 bytes spill" not in line:
            keep.append(line.strip())
    return keep


def _launch(name, device, *args):
    """Entry point `name` on `device`'s current stream, entering the device
    only when it is not the current one (as `_kernels.launch` does);
    raises if the launch failed."""
    lib = library()
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    with torch.cuda.device(index) if index != current else contextlib.nullcontext():
        err = getattr(lib, name)(*args, torch.cuda.current_stream(index).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: launch failed with CUDA error {err} "
                           f"({lib.vst_cuda_error_string(err).decode()})")


def _check_arm_operands(q, k, v):
    denseattn._check(q, k, v)
    if q.dtype != torch.bfloat16 or q.shape[-1] != 64:
        raise ValueError(f"the arms take bf16 heads of 64, got {q.dtype}, D = {q.shape[-1]}")
    denseattn._check_kernel_operands(q, k, v)


def attn_bwd_arm(arm, q, k, v, o, lse, do, scale: float):
    """K2's arm `arm` (BWD_ARMS): (dq, dk, dv) of q, k, v, o, do [B, N, H,
    64] bf16 and lse [B, H, N] f32, as denseattn.dense_attention_bwd takes
    them. A CUDA tensor launches the arm (one more in
    bwd_launches[arm]); a CPU tensor takes its plain version (exact arms
    and rows64 only: a strip has none)."""
    if arm not in BWD_ARMS:
        raise ValueError(f"unknown K2 arm {arm!r}")
    if q.device.type == "cpu":
        if arm not in BWD_PLAIN:
            raise ValueError(f"no plain version of K2 arm {arm!r} (exact arms: "
                             f"{tuple(BWD_PLAIN)})")
        return BWD_PLAIN[arm](q, k, v, o, lse, do, scale)
    _check_arm_operands(q, k, v)
    b, n, h, d = q.shape
    o, do, lse = o.contiguous(), do.contiguous(), lse.float().contiguous()
    if o.shape != q.shape or do.shape != q.shape or lse.shape != (b, h, n):
        raise ValueError("o and dO must be [B, N, H, D] and lse [B, H, N]")
    dq, dk, dv, qc = (torch.empty_like(o) for _ in range(4))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    aug = lambda on: (torch.empty((b * h * n, 16), dtype=torch.bfloat16, device=q.device)
                      if on else None)
    aug_l, aug_d = aug(arm in FOLD_LSE), aug(arm in FOLD_DELTA)
    ptr = lambda t: None if t is None else t.data_ptr()
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    _launch("vst_attn_arm_bwd", q.device, BWD_ARMS[arm], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            qc.data_ptr(), ptr(aug_l), ptr(aug_d), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, h, n, sb, sn, sh, ob, on, oh, float(scale * denseattn.LOG2E), float(scale))
    bwd_launches[arm] += 1
    return dq, dk, dv


def attn_fwd_arm(arm, q, k, v, scale: float):
    """K1's arm `arm` (FWD_ARMS): (o [B, N, H, 64], lse [B, H, N] f32) of
    q, k, v as denseattn.dense_attention_fwd takes them. A CUDA tensor
    launches the arm (one more in fwd_launches[arm]); a CPU tensor takes
    its plain version (bf16max, nc1, nc2: a strip has none)."""
    if arm not in FWD_ARMS:
        raise ValueError(f"unknown K1 arm {arm!r}")
    if q.device.type == "cpu":
        if arm not in FWD_PLAIN:
            raise ValueError(f"no plain version of K1 arm {arm!r} (exact arms: {FWD_EXACT})")
        return FWD_PLAIN[arm](q, k, v, scale)
    _check_arm_operands(q, k, v)
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    code, nc = FWD_ARMS[arm]
    _launch("vst_attn_arm_fwd", q.device, code, nc, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), lse.data_ptr(), b, h, n, sb, sn, sh, ob, on, oh,
            float(scale * denseattn.LOG2E))
    fwd_launches[arm] += 1
    return o, lse


def reset_launches():
    for counts in (bwd_launches, fwd_launches):
        for name in counts:
            counts[name] = 0


def bwd_launcher(arm):
    """A stand-in for denseattn._launch_bwd that launches K2's arm `arm`."""
    return lambda q, k, v, o, lse, do, scale: attn_bwd_arm(arm, q, k, v, o, lse, do, scale)


def fwd_launcher(arm):
    """A stand-in for denseattn._launch_fwd that launches K1's arm `arm`."""
    return lambda q, k, v, scale: attn_fwd_arm(arm, q, k, v, scale)


# ---- checks and times ---------------------------------------------------------

def _fmt(xs):
    return ", ".join(f"{x:.3e}" for x in xs)


def check_arms(smoke, dev, gen, b):
    """Every arm at [B, N, H, 64] bf16 (chip_smoke.py's `_attn_inputs`), on
    the package's O and LSE2. Each exact arm is held to its plain version
    at chip_smoke.py's bf16 bounds (K1_BF16_O_TOL, K1_BF16_LSE_TOL, for
    bf16max's LSE2 K1_BF16MAX_LSE_TOL, K2_BF16_TOL) and bitwise from run
    to run; an arm of SAME_AS_PACKAGE is held bitwise to the package's
    kernel, and every other exact arm must differ from it somewhere (one
    whose hook compiled away would give the package's bits). Each strip's
    kept outputs (BWD_KEPT, FWD_KEPT) are held bitwise to the package's
    kernel; a strip that keeps none is timed only, its max_abs_err None.
    Then every arm timed by `smoke._sync_ms` (runs of 10 calls) in turns
    with the package's kernel first and last, beside the plain version (an
    exact arm's own, else the package's), the bound of the function the
    arm computes and SDPA's call. Returns {("fwd" | "bwd", arm): numbers}
    ("full" the package's kernel); raises AssertionError if an arm fails
    its check."""
    d, dt = 64, torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, N, H, d, dt, gen, dev)
    do = torch.randn(b, N, H, d, generator=gen, device=dev).to(dt)
    o, lse = denseattn._launch_fwd(q, k, v, scale)
    full = {"bwd": denseattn._launch_bwd(q, k, v, o, lse, do, scale), "fwd": (o, lse)}
    torch.cuda.synchronize()
    tag = f"B={b} N={N} H={H} D={d} bfloat16"
    names = {"bwd": ("dq", "dk", "dv"), "fwd": ("O", "LSE2")}
    runs = {("bwd", "full"): lambda: denseattn._launch_bwd(q, k, v, o, lse, do, scale),
            **{("bwd", a): functools.partial(attn_bwd_arm, a, q, k, v, o, lse, do, scale)
               for a in BWD_ARMS},
            ("fwd", "full"): lambda: denseattn._launch_fwd(q, k, v, scale),
            **{("fwd", a): functools.partial(attn_fwd_arm, a, q, k, v, scale)
               for a in FWD_ARMS}}
    plains = {**{("bwd", a): functools.partial(f, q, k, v, o, lse, do, scale)
                 for a, f in BWD_PLAIN.items()},
              **{("fwd", a): functools.partial(f, q, k, v, scale) for a, f in FWD_PLAIN.items()}}
    res, failed = {}, []
    for (part, arm), run in runs.items():
        res[(part, arm)] = r = {}
        if arm == "full":
            continue
        ref = full[part]
        got, again = run(), run()
        torch.cuda.synchronize()
        r["repeat"] = all(torch.equal(x, y) for x, y in zip(got, again))
        r["from_package"] = [smoke._max_err(x, y) for x, y in zip(got, ref)]
        r["max_abs_err"] = None
        line = (f"K{'2' if part == 'bwd' else '1'} {arm} {tag}: from the package's kernel "
                f"({', '.join(names[part])}) {_fmt(r['from_package'])}")
        if (part, arm) in plains:
            want = plains[(part, arm)]()
            errs = [smoke._max_err(x, y) for x, y in zip(got, want)]
            if part == "bwd":
                bounds = [smoke.K2_BF16_TOL * float(w.float().abs().max()) for w in want]
            else:
                lse_tol = smoke.K1_BF16MAX_LSE_TOL if arm == "bf16max" else smoke.K1_BF16_LSE_TOL
                bounds = [smoke.K1_BF16_O_TOL * max(1.0, float(want[0].float().abs().max())),
                          lse_tol * max(1.0, float(want[1].abs().max()))]
            r["max_abs_err"] = max(errs)
            r["package_bitwise"] = all(torch.equal(x, y) for x, y in zip(got, ref))
            ok = (r["repeat"] and all(e <= t for e, t in zip(errs, bounds))
                  and r["package_bitwise"] == (arm in SAME_AS_PACKAGE))
            line += ("; from its plain version " + ", ".join(
                f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
                + f"; bitwise equal to the package's kernel {r['package_bitwise']} (wanted "
                f"{arm in SAME_AS_PACKAGE}); repeat bitwise equal {r['repeat']}")
        else:
            kept = (BWD_KEPT if part == "bwd" else FWD_KEPT)[arm]
            r["kept_bitwise"] = ok = all(torch.equal(got[i], ref[i]) for i in kept)
            if kept:
                r["max_abs_err"] = max(r["from_package"][i] for i in kept)
            line += (f"; kept outputs {[names[part][i] for i in kept]} bitwise equal to the "
                     f"package's: {ok}")
        print(line, flush=True)
        if not ok:
            failed.append(f"K{'2' if part == 'bwd' else '1'} {arm}")

    # times: the package's kernel first and last
    for part in ("bwd", "fwd"):
        order = [key for key in runs if key[0] == part and key[1] != "full"]
        times = collections.defaultdict(list)
        for key in [(part, "full"), *order, (part, "full")]:
            times[key].append(smoke._sync_ms(runs[key], 10))
        for key, ms in times.items():
            res[key]["ms"] = statistics.mean(ms)
            res[key]["ms_runs"] = ms
    lib_f, lib_b, _ = smoke._sdpa_ms(q, k, v, do, scale)
    package_plain = {"bwd": smoke._sync_ms(lambda: denseattn.dense_attention_bwd_plain(
                         q, k, v, o, lse, do, scale), 3, 1),
                     "fwd": smoke._sync_ms(lambda: denseattn.dense_attention_fwd_plain(
                         q, k, v, scale), 3, 1)}
    elems, bhn, es, unit = b * N * H * d, b * H * N, q.element_size(), b * H * N * N * d
    for (part, arm), r in res.items():
        if part == "bwd":
            needed, executed = BWD_NEEDED.get(arm, 10), BWD_EXECUTED[arm]
            nbytes = 8 * es * elems + 4 * bhn
            r["library_ms"] = lib_b
        else:
            needed, executed = FWD_NEEDED.get(arm, 4), FWD_EXECUTED[arm]
            nbytes = 4 * es * elems + 4 * bhn
            r["library_ms"] = lib_f
        own = (part, arm) in plains and arm not in SAME_AS_PACKAGE
        r["plain_ms"] = (smoke._sync_ms(plains[(part, arm)], 3, 1) if own
                         else package_plain[part])
        r.update(smoke._bound(needed * unit, nbytes, dt))
        r["executed_tflop"] = executed * unit / 1e12
        print(f"K{'2' if part == 'bwd' else '1'} {arm} {tag}: "
              f"{r['ms']:.4f} ms ({', '.join(f'{t:.4f}' for t in r['ms_runs'])}), "
              f"{executed} B H N^2 D executed = {r['executed_tflop']:.4f} TFLOP "
              f"({r['executed_tflop'] / r['ms'] * 1e3:.1f} TFLOP/s executed); bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}, {needed} B H N^2 D needed), plain "
              f"{r['plain_ms']:.4f} ms, sdpa {'backward' if part == 'bwd' else 'forward'} "
              f"{r['library_ms']:.4f} ms", flush=True)
    if failed:
        raise AssertionError(f"attention arms failed their checks at {tag}: {failed}")
    return res


def kernel_ms(fn, calls=10):
    """Device ms a call of each CUDA kernel fn() launches, by kernel name
    (torch.profiler)."""
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = collections.Counter()
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us[e.name] += e.time_range.elapsed_us()
    return {name: t / 1e3 / calls for name, t in us.items()}


def _piece(name):
    """The K1/K2 kernel a profiler name belongs to."""
    for key, piece in (("preprocess", "preprocess"), ("dkdv", "dK/dV"), ("dq_", "dQ"),
                       ("fwd", "forward")):
        if key in name:
            return piece
    return name[:60]


def device_breakdown(smoke, dev, gen, b):
    """The device time of each kernel of each arm at [B, N, H, 64] bf16
    (torch.profiler, 10 calls): {(part, arm): {piece: ms}}."""
    d, dt = 64, torch.bfloat16
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, N, H, d, dt, gen, dev)
    do = torch.randn(b, N, H, d, generator=gen, device=dev).to(dt)
    o, lse = denseattn._launch_fwd(q, k, v, scale)
    runs = {("bwd", "full"): lambda: denseattn._launch_bwd(q, k, v, o, lse, do, scale),
            ("fwd", "full"): lambda: denseattn._launch_fwd(q, k, v, scale)}
    runs.update({("bwd", a): functools.partial(attn_bwd_arm, a, q, k, v, o, lse, do, scale)
                 for a in BWD_ARMS})
    runs.update({("fwd", a): functools.partial(attn_fwd_arm, a, q, k, v, scale)
                 for a in FWD_ARMS})
    out = {}
    for key, fn in runs.items():
        pieces = collections.Counter()
        for name, ms in kernel_ms(fn).items():
            pieces[_piece(name)] += ms
        out[key] = dict(pieces)
        print(f"K{'2' if key[0] == 'bwd' else '1'} {key[1]} B={b} N={N} H={H} D={d} device ms "
              "a call: " + "; ".join(f"{p} {t:.4f}" for p, t in sorted(pieces.items()))
              + f"; total {sum(pieces.values()):.4f}", flush=True)
    return out


# ---- the arms in the SetVAE step ------------------------------------------------

def _step_run(smoke, dev, train, steps, patch):
    """The SetVAE bf16 B = 64 train (or eval) step of the shipped config,
    built from chip_smoke.py's seed, with `patch` (a context manager)
    in place: median ms over `steps` steps after 2 warm-ups (host clock,
    each step ending in a scalar fetch) and the last step's loss terms."""
    from vae_song_tpu_torch.train.steps import make_accum_train_step, make_eval_step
    from vae_song_tpu_torch.train.state import make_optimizer

    params, batch = smoke.MODEL_PARAMS, smoke.BATCH
    model = smoke._build("setvae", params).to(dev)
    if train:
        opt_step = make_accum_train_step(model, make_optimizer(model.parameters(), lr=smoke.LR),
                                         1)
        step = lambda x, e: opt_step(x, e, 0.5, None)
    else:
        step = make_eval_step(model)
    xs, eps = smoke._clouds_and_noise(steps + 2, batch, params, dev, smoke.SEED + 4)
    times, terms = [], None
    with patch:
        for i in range(steps + 2):
            t0 = time.perf_counter()
            terms = {key: float(val) for key, val in step(xs[i], eps[i]).items()}
            if i >= 2:
                times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), terms


def _patched(arm, part):
    """`arm` in place of the package's launcher of `part` ("package": none;
    "plain": the package's plain backward)."""
    if arm == "package":
        return contextlib.nullcontext()
    if arm == "plain":
        return mock.patch.object(denseattn, "_launch_bwd", denseattn.dense_attention_bwd_plain)
    if part == "bwd":
        return mock.patch.object(denseattn, "_launch_bwd", bwd_launcher(arm))
    return mock.patch.object(denseattn, "_launch_fwd", fwd_launcher(arm))


def _print_step(smoke, what, who, ab, ms, terms):
    print(f"SetVAE B={smoke.BATCH} bf16 {what}, "
          f"{'the package' if who == 'package' else 'arm ' + who} ({ab}): "
          f"{ms:.3f} ms median of {STEPS}; loss terms "
          + ", ".join(f"{key} {val:.6f}" for key, val in sorted(terms.items())), flush=True)
    if not all(math.isfinite(val) for val in terms.values()):
        raise AssertionError(f"{what} with {who}: non-finite loss terms {terms}")


def in_step(smoke, dev):
    """The in-step A/B: the train step with the package's K2, then each
    exact K2 arm (and rows64), in the order package, arm, arm, package; the
    eval step likewise for K1 bf16max; then the control, the train step
    with the package's plain backward (rounding of bf16 size in other
    places than the arms', same steps, loss terms only). Returns {(part,
    arm): [ms, ...]} and prints each run with its loss terms."""
    out = collections.defaultdict(list)
    for part, arms in (("bwd", tuple(BWD_PLAIN)), ("fwd", ("bf16max",))):
        what = "train step" if part == "bwd" else "eval step"
        for arm in arms:
            for who in ("package", arm, arm, "package"):
                ms, terms = _step_run(smoke, dev, part == "bwd", STEPS, _patched(who, part))
                out[(part, who)].append(ms)
                _print_step(smoke, what, who, f"A/B of {arm}", ms, terms)
    ms, terms = _step_run(smoke, dev, True, STEPS, _patched("plain", "bwd"))
    _print_step(smoke, "train step", "plain", "the package's plain backward, a control of the "
                "loss terms", ms, terms)
    return out


def drive_path(smoke, dev):
    """Every arm in the SetVAE bf16 B = 64 step once (the K2 arms in the
    train step, the K1 arms in the eval step), from a fresh model each:
    the arms' path. Exact arms must give finite loss terms. Returns the
    loss terms by (part, arm)."""
    out = {}
    for part, arms in (("bwd", tuple(BWD_ARMS)), ("fwd", tuple(FWD_ARMS))):
        for arm in arms:
            _, terms = _step_run(smoke, dev, part == "bwd", 1, _patched(arm, part))
            out[(part, arm)] = terms
            exact = arm in (BWD_PLAIN if part == "bwd" else FWD_EXACT)
            if exact and not all(math.isfinite(val) for val in terms.values()):
                raise AssertionError(f"{part} arm {arm} in the step: non-finite loss {terms}")
    return out


# the package's sources that hold K1 and K2 (and K3, the same kernels)
COMPARED = ("dense_attn_fwd.cu", "dense_attn_bwd.cu")
# the hashes of the anonymous namespace in a mangled name, which follow
# the source's path
_ANON = re.compile(r"(_GLOBAL__N__)[0-9a-f]{8}(_\d+_\w+?_cu_)[0-9a-f]{8}")


def _unhashed(text):
    return _ANON.sub(r"\1\2", text)


def _ptxas_by_function(log):
    """{entry function: its ptxas spill and register lines} of an nvcc -v
    log."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = _unhashed(m.group(1))
            out[name] = []
        elif name is not None and ("spill" in line or "registers" in line):
            out[name].append(line.split(":", 1)[-1].strip() if "ptxas" in line else line.strip())
    return out


def _sass_by_function(obj):
    """{function: its SASS instructions, without addresses and encodings}
    of the object `obj`."""
    cuobjdump = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            name = _unhashed(line.split("Function :", 1)[1].strip())
            out[name] = []
        elif name is not None:
            ins = re.sub(r"/\*[^*]*\*/", "", line).strip()
            if ins and not ins.startswith("."):
                out[name].append(_unhashed(ins))
    return out


def compare_build(parent, removed=()):
    """Every kernel of COMPARED compiled from `parent` and from ROOT: prints
    each one's ptxas lines and whether its SASS is the same; returns True
    if every one is, with the same ptxas lines, in both. A kernel only in
    the parent whose name holds one of the strings `removed` was deleted on
    purpose: listed, not counted against the result."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for who, tree in (("parent", Path(parent).resolve()), ("this", ROOT)):
        for src in COMPARED:
            obj = BUILD_DIR / f"compare.{os.getpid()}.{who}.{src}.o"
            proc = subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-c", "-o", str(obj),
                                     str(tree / "vae_song_tpu_torch" / "csrc" / src)],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            jobs.append((who, src, obj, proc))
    built = {}
    for who, src, obj, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for the {who} checkout's {src}:\n{log[-3000:]}")
        built[(who, src)] = (_ptxas_by_function(log), _sass_by_function(obj))
        obj.unlink(missing_ok=True)
    same = True
    for src in COMPARED:
        (ptx_p, sass_p), (ptx_t, sass_t) = built[("parent", src)], built[("this", src)]
        gone = sorted(n for n in set(sass_p) - set(sass_t) if any(r in n for r in removed))
        if gone:
            print(f"{src}: kernels deleted from the parent's: {gone}")
        if set(sass_p) - set(gone) != set(sass_t):
            same = False
            print(f"{src}: kernels only in the parent {sorted(set(sass_p) - set(sass_t))}; "
                  f"only in this checkout {sorted(set(sass_t) - set(sass_p))}")
        n_same = 0
        for name in sorted(set(sass_p) & set(sass_t)):
            equal = sass_p[name] == sass_t[name] and ptx_p.get(name) == ptx_t.get(name)
            n_same += equal
            same = same and equal
            short = re.sub(r"^_ZN\d+_GLOBAL__N___\d+_\w+?_cu_\d+", "", name)[:70]
            print(f"{src} {short}: {'; '.join(ptx_t.get(name, []))}; SASS and ptxas the same: "
                  f"{equal} ({len(sass_t[name])} instructions)", flush=True)
            if not equal:
                print(f"  parent ptxas {ptx_p.get(name)}")
                diff = [(i, x, y) for i, (x, y) in enumerate(zip(sass_p[name], sass_t[name]))
                        if x != y]
                for i, x, y in diff[:8]:
                    print(f"  instruction {i}: parent {x} | this {y}")
        print(f"{src}: {n_same} of {len(sass_p) - len(gone)} kernels the parent's SASS and ptxas "
              f"lines",
              flush=True)
    return same


def _load_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke_arms", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def main():
    smoke = _load_smoke()
    smoke.phase_environment()
    same = _PARENT is None or compare_build(_PARENT)
    dev = torch.device("cuda", 0)
    t0 = time.perf_counter()
    handle = start_build()
    _kernels.library()
    library(handle)
    print(f"build (package and arms): {time.perf_counter() - t0:.1f} s; arms' ptxas:")
    for line in ptxas_lines():
        print("  " + line)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    for b in (smoke.BATCH, 1):
        check_arms(smoke, dev, gen, b)
    if not same:
        raise SystemExit("the package's attention kernels differ from the parent's")
    steps = in_step(smoke, dev)
    for (part, who), ms in steps.items():
        print(f"in-step {part} {who}: " + ", ".join(f"{t:.3f}" for t in ms) + " ms")
    # profiler sessions last: the steps timed after one read slower on some
    # runs (chip_smoke.py's _device_ms)
    for b in (smoke.BATCH, 1):
        device_breakdown(smoke, dev, gen, b)


if __name__ == "__main__":
    main()
