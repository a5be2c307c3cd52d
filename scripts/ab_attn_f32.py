"""Checks and times the f32 attention kernels (K1/K2 on the packed route,
K3f/K3b on the BHND route) of one checkout of this repository on one
CUDA card, by this checkout's chip_smoke.py, so that two checkouts run in
one call compare by one method:

    python scripts/ab_attn_f32.py [ROOT] [--narrow | --wide] [--compare PARENT]
    python scripts/ab_attn_f32.py --dq-recompute

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported and its kernels build into
ROOT/build/cuda. The checks are chip_smoke.py's: phase 1 (the card's name
and power limit), phase 2 (the build, with ptxas's register and spill
lines) and phase 3's `check_attention` on every f32 case of both routes:
D = 64 and 128 (B = 4, the f32 path's B = 64, N = 192 at B = 64 and the
decoder's B = 1; runs of 10 calls) and the heads of 192 and wider (runs of
3 calls): each at chip_smoke.py's bounds (O against the plain version, the
gradients against a float64 version), no farther from float64 than the
plain version and bitwise from run to run (a case that fails prints why,
and the next case runs), timed beside the split-TF32 and FMA bounds, the
plain version and SDPA's f32 call.
Then the device time a call of each kernel of the forward and the
backward takes (torch.profiler, 10 calls; 3 above D = 128; a kernel
launched more than once a call, as the split pre-pass, one line a launch,
#1, #2 in launch order) at B = 64, N = 2048 on each route (D = 64, H = 4
and D = 128, H = 2), and at one head of 256 (B = 64) and of 512 (B = 8
and B = 1).
--narrow: only the heads of 64 and 128; --wide: only those of 192 and
wider (their checks and device times).
--compare PARENT (a checkout of the parent commit): first compile both
checkouts' csrc/dense_attn_fwd.cu, dense_attn_bwd.cu, dense_attn_scores.cu,
ffn_fwd.cu and ffn_bwd.cu (every source that includes sm90.cuh beside the
f32 attention's dense_attn_tf32.cu and dense_attn_tf32_wide.cu) and
compare every kernel's SASS and ptxas lines (scripts/ab_attn_arms.py's
compare_build; the split-TF32 mma.sync attention kernels, deleted from
dense_attn_fwd.cu and dense_attn_bwd.cu, listed apart), as evidence that
the other kernels are the parent's. Run parent, this checkout, this
checkout, parent in one call to A/B the two.
--dq-recompute (this checkout only): the A/B of the backward's dQ at D =
64 and 128, B = 64 and 4: the package's dQ, a product over the dK/dV
kernel's dS^T scratch (10 B H N^2 D), against scripts/ab_attn_f32_dq.cu's
arm, whose dK/dV kernel writes no dS^T and whose dQ kernel recomputes S
and dP (14 B H N^2 D, no N^2 scratch); built with nvcc into
build/ab_attn_f32_dq/. Each side's gradients against float64, its device
ms a kernel, and the whole backward's device ms (CUDA events over 10
calls, package, arm, arm, package; the package's includes its preprocess,
the arm takes delta from it).
"""

import collections
import ctypes
import importlib.util
import math
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ARGV = sys.argv[1:]
PARENT = _ARGV[_ARGV.index("--compare") + 1] if "--compare" in _ARGV else None
WIDE_ONLY = "--wide" in _ARGV
NARROW_ONLY = "--narrow" in _ARGV
DQ_RECOMPUTE = "--dq-recompute" in _ARGV
_ROOTS = [a for a in _ARGV if not a.startswith("--") and a != PARENT]
ROOT = os.path.abspath(_ROOTS[0] if _ROOTS else HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from vae_song_tpu_torch.ops import denseattn  # noqa: E402

# A checkout from before the split-TF32 wgmma kernels for heads of 64 and
# 128, or for heads of 192 and wider, or before the bf16 wgmma kernels for
# heads of 192 and 256, has no launch counters for them, which
# chip_smoke.py's COUNTERS name: give it idle ones, which nothing here
# reads, and a route rule that takes no shape to the kernels at 64 and 128.
for _name in ("tf32_narrow_fwd", "tf32_narrow_bwd", "tf32_wide_fwd", "tf32_wide_bwd",
              "wgmma_wide_fwd", "wgmma_wide_bwd"):
    if not hasattr(denseattn, _name):
        setattr(denseattn, _name, types.SimpleNamespace(launches=0))
if not hasattr(denseattn, "tf32_narrow"):
    denseattn.tf32_narrow = lambda dtype, d: False

_spec = importlib.util.spec_from_file_location("chip_smoke_checks",
                                               os.path.join(HERE, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the per-kernel breakdown's BHND shapes beside each route's B = 64 case
WIDE_BREAKDOWN = ((smoke.BATCH, smoke.NPTS, 1, 256), (8, smoke.NPTS, 1, 512),
                  (1, smoke.NPTS, 1, 512))


def _f32(cases, wide):
    return tuple(c for c in cases if c[4] == torch.float32 and (c[3] >= 192) == wide)


def _kernel_ms(fn, calls=10):
    """Device ms a call of each CUDA kernel fn() launches, by kernel name;
    a kernel launched k > 1 times a call by name and #i, its i-th launch
    of the call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    per_call = {name: n // calls
                for name, n in collections.Counter(e.name for e in events).items()}
    seen, us = collections.Counter(), collections.Counter()
    for e in events:
        k = per_call[e.name]
        label = e.name if k <= 1 else f"{e.name[:80]} #{seen[e.name] % k + 1}"
        seen[e.name] += 1
        us[label] += e.time_range.elapsed_us()
    return {name: t / 1e3 / calls for name, t in us.items()}


def _breakdown(dev, gen, name, fwd, bwd, shape):
    b, n, h, d = shape
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, n, h, d, torch.float32, gen, dev)
    do = torch.randn(b, n, h, d, generator=gen, device=dev)
    o, lse = fwd(q, k, v, scale)
    for part, fn in (("fwd", lambda: fwd(q, k, v, scale)),
                     ("bwd", lambda: bwd(q, k, v, o, lse, do, scale))):
        times = _kernel_ms(fn, 10 if d <= 128 else 3)
        print(f"{name} B={b} N={n} H={h} D={d} float32 {part} device ms a call: "
              + "; ".join(f"{k_[:90]} {t:.4f}" for k_, t in sorted(times.items()))
              + f"; total {sum(times.values()):.4f}")


# the sources beside the f32 attention's (dense_attn_tf32.cu,
# dense_attn_tf32_wide.cu) that include csrc/sm90.cuh, which the f32
# kernels extend
COMPARED = ("dense_attn_fwd.cu", "dense_attn_bwd.cu", "dense_attn_scores.cu", "ffn_fwd.cu",
            "ffn_bwd.cu")
# the split-TF32 mma.sync attention kernels, deleted from dense_attn_fwd.cu
# and dense_attn_bwd.cu in favour of dense_attn_tf32.cu's
REMOVED = ("dense_attn_fwd_tf32_kernel", "attn_bwd_dkdv_tf32_kernel", "attn_bwd_dq_tf32_kernel")


def _compare(parent):
    """scripts/ab_attn_arms.py's compare_build of this checkout against
    `parent` over COMPARED: True if every kernel of them is the parent's."""
    spec = importlib.util.spec_from_file_location(
        "ab_attn_arms_compare", os.path.join(HERE, "scripts", "ab_attn_arms.py"))
    arms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(arms)
    arms.COMPARED = COMPARED
    return arms.compare_build(parent, REMOVED)


def _dq_library():
    """Compile scripts/ab_attn_f32_dq.cu (the package's flags) unless built
    for these sources, and load it."""
    from vae_song_tpu_torch import _kernels
    src = os.path.join(HERE, "scripts", "ab_attn_f32_dq.cu")
    deps = [src] + [str(p) for p in _kernels._sources()]
    stamp = max(os.stat(p).st_mtime_ns for p in deps)
    out = os.path.join(HERE, "build", "ab_attn_f32_dq")
    so = os.path.join(out, f"ab_attn_f32_dq_{stamp}.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        built = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, src],
                               capture_output=True, text=True, check=False)
        print("\n".join(line for line in (built.stdout + built.stderr).splitlines()
                        if "registers" in line or "spill" in line or "error" in line
                        or "dq_recompute" in line))
        if built.returncode != 0:
            raise SystemExit("nvcc failed for scripts/ab_attn_f32_dq.cu")
    lib = ctypes.CDLL(so)
    P, I, L, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    lib.vst_ab_dq_recompute_scratch.argtypes = (I, I, I, I)
    lib.vst_ab_dq_recompute_scratch.restype = L
    lib.vst_ab_attn_bwd_dq_recompute.argtypes = (*(P,) * 10, I, I, I, I, *(L,) * 6, F, F, P)
    lib.vst_ab_attn_bwd_dq_recompute.restype = I
    return lib


def _events_ms(fn, calls=10):
    """Device ms a call of fn() over `calls` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _dq_recompute_ab(dev, gen):
    """The dQ A/B (--dq-recompute): see the module's docstring."""
    lib = _dq_library()
    da = smoke.denseattn
    for b, n, h, d in ((smoke.BATCH, smoke.NPTS, 4, 64), (smoke.BATCH, smoke.NPTS, 2, 128),
                       (4, smoke.NPTS, 4, 64), (4, smoke.NPTS, 2, 128)):
        scale = 1.0 / math.sqrt(d)
        q, k, v = smoke._attn_inputs(b, n, h, d, torch.float32, gen, dev)
        do = torch.randn(b, n, h, d, generator=gen, device=dev)
        o, lse = da.dense_attention_bhnd(q, k, v, scale)
        delta = (do * o).sum(-1).permute(0, 2, 1).contiguous()
        scratch = torch.empty(lib.vst_ab_dq_recompute_scratch(b, h, n, d), dtype=torch.uint8,
                              device=dev)
        got = [torch.empty_like(o) for _ in range(3)]
        sb, sn, sh, _ = q.stride()
        ob, on, oh, _ = o.stride()

        def arm():
            err = lib.vst_ab_attn_bwd_dq_recompute(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                delta.data_ptr(), *(g.data_ptr() for g in got), scratch.data_ptr(), b, h, n, d,
                sb, sn, sh, ob, on, oh, scale * da.LOG2E, scale,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"the dQ recompute arm failed: error {err}")

        def package():
            return da.dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale)

        arm()
        mine = package()
        torch.cuda.synchronize()
        f64 = smoke._attn_bwd_f64(q, k, v, o, lse, do, scale)
        tag = f"B={b} N={n} H={h} D={d} float32"
        for name, grads in (("package (dS^T scratch)", mine), ("arm (dQ recomputes)", got)):
            errs = [smoke._max_err(g_, w_) for g_, w_ in zip(grads, f64)]
            bounds = [smoke.K2_F32_TOL * float(w_.abs().max()) for w_ in f64]
            print(f"dQ A/B {tag} {name}: max|d dq,dk,dv| from float64 "
                  + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds)))
        times = [_events_ms(package), _events_ms(arm), _events_ms(arm), _events_ms(package)]
        print(f"dQ A/B {tag} whole backward device ms (events, 10 calls): package "
              f"{times[0]:.4f}, arm {times[1]:.4f}, arm {times[2]:.4f}, package {times[3]:.4f}")
        for name, fn in (("package", package), ("arm", arm)):
            ms = _kernel_ms(fn)
            print(f"dQ A/B {tag} {name} device ms a call: "
                  + "; ".join(f"{k_[:90]} {t:.4f}" for k_, t in sorted(ms.items()))
                  + f"; total {sum(ms.values()):.4f}")
        del scratch, got


def main():
    print(f"root {ROOT}")
    smoke.phase_environment()
    if PARENT is not None:
        print(f"the kernels of {', '.join(COMPARED)} "
              f"the parent's SASS and ptxas lines: {_compare(PARENT)}", flush=True)
    dev = torch.device("cuda", 0)
    smoke._timed(smoke.phase_build)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    if DQ_RECOMPUTE:
        _dq_recompute_ab(dev, gen)
        return
    da = smoke.denseattn
    # each route's cases and its f32 case at B = 1
    b1_packed, b1_bhnd = smoke.F32_B1_CASES
    routes = (("dense_attn (packed route)", da.dense_attention_fwd, da.dense_attention_bwd,
               smoke.K1_CASES + (b1_packed,), smoke.K1_F32_TOL),
              ("dense_attn (BHND route)", da.dense_attention_bhnd, da.dense_attention_bwd_bhnd,
               smoke.K3_CASES + (b1_bhnd,), smoke.K3_F32_O_TOL))
    for name, fwd, bwd, cases, tol in routes:
        for wide, iters in ((False, 10), (True, 3)):
            if (WIDE_ONLY and not wide) or (NARROW_ONLY and wide):
                continue
            for case in _f32(cases, wide):
                try:
                    smoke.check_attention(dev, gen, name, fwd, bwd, (case,), tol, iters=iters)
                except AssertionError as e:
                    print(f"FAILED: {e}")
    for name, fwd, bwd, cases, _ in routes:
        if WIDE_ONLY:
            break
        shape = next(c[:4] for c in _f32(cases, False)
                     if c[0] == smoke.BATCH and c[1] == smoke.NPTS)
        _breakdown(dev, gen, name, fwd, bwd, shape)
    for shape in () if NARROW_ONLY else WIDE_BREAKDOWN:
        _breakdown(dev, gen, routes[1][0], da.dense_attention_bhnd, da.dense_attention_bwd_bhnd,
                   shape)


if __name__ == "__main__":
    main()
