"""Checks and times the f32 attention kernels (K1/K2 on the packed route,
K3f/K3b on the BHND route) of one checkout of this repository on one
CUDA card, by this checkout's chip_smoke.py, so that two checkouts run in
one call compare by one method:

    python scripts/ab_attn_f32.py [ROOT] [--wide] [--compare PARENT]

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported and its kernels build into
ROOT/build/cuda. The checks are chip_smoke.py's: phase 1 (the card's name
and power limit), phase 2 (the build, with ptxas's register and spill
lines) and phase 3's `check_attention` on every f32 case of both routes:
D = 64 and 128 (B = 4, the f32 path's B = 64, and N = 192 at B = 64; runs
of 10 calls) and the heads of 192 and wider (runs of 3 calls): each at
chip_smoke.py's bounds (O against the plain version, the gradients
against a float64 version), no farther from float64 than the plain
version and bitwise from run to run (a case that fails prints why, and
the next case runs), timed beside the split-TF32 and FMA bounds, the
plain version and SDPA's f32 call.
Then the device time a call of each kernel of the forward and the
backward takes (torch.profiler, 10 calls; 3 above D = 128; a kernel
launched more than once a call, as the product kernel for dV and then
dK, one line a launch, #1, #2 in launch order) at B = 64, N = 2048 on
each route (D = 64, H = 4 and D = 128, H = 2), and at one head of 256
(B = 64) and of 512 (B = 8 and B = 1).
--wide: only the heads of 192 and wider (their checks and device times).
--compare PARENT (a checkout of the parent commit): first compile both
checkouts' csrc/dense_attn_fwd.cu, dense_attn_bwd.cu, dense_attn_scores.cu,
ffn_fwd.cu and ffn_bwd.cu (every source beside dense_attn_tf32_wide.cu
that includes sm90.cuh) and compare every kernel's SASS and ptxas lines
(scripts/ab_attn_arms.py's compare_build), as evidence that the other
kernels are the parent's. Run parent, this checkout, this checkout,
parent in one call to A/B the two.
"""

import collections
import importlib.util
import math
import os
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_ARGV = sys.argv[1:]
PARENT = _ARGV[_ARGV.index("--compare") + 1] if "--compare" in _ARGV else None
WIDE_ONLY = "--wide" in _ARGV
_ROOTS = [a for a in _ARGV if not a.startswith("--") and a != PARENT]
ROOT = os.path.abspath(_ROOTS[0] if _ROOTS else HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from vae_song_tpu_torch.ops import denseattn  # noqa: E402

# A checkout from before the split-TF32 kernels for heads of 192 and wider,
# or before the bf16 wgmma kernels for heads of 192 and 256, has no launch
# counters for them, which chip_smoke.py's COUNTERS name: give it idle
# ones, which nothing here reads.
for _name in ("tf32_wide_fwd", "tf32_wide_bwd", "wgmma_wide_fwd", "wgmma_wide_bwd"):
    if not hasattr(denseattn, _name):
        setattr(denseattn, _name, types.SimpleNamespace(launches=0))

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


# the sources beside dense_attn_tf32_wide.cu that include csrc/sm90.cuh,
# which the f32 kernels from D = 192 extend
COMPARED = ("dense_attn_fwd.cu", "dense_attn_bwd.cu", "dense_attn_scores.cu", "ffn_fwd.cu",
            "ffn_bwd.cu")


def _compare(parent):
    """scripts/ab_attn_arms.py's compare_build of this checkout against
    `parent` over COMPARED: True if every kernel of them is the parent's."""
    spec = importlib.util.spec_from_file_location(
        "ab_attn_arms_compare", os.path.join(HERE, "scripts", "ab_attn_arms.py"))
    arms = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(arms)
    arms.COMPARED = COMPARED
    return arms.compare_build(parent)


def main():
    print(f"root {ROOT}")
    smoke.phase_environment()
    if PARENT is not None:
        print(f"the kernels of {', '.join(COMPARED)} "
              f"the parent's SASS and ptxas lines: {_compare(PARENT)}", flush=True)
    dev = torch.device("cuda", 0)
    smoke._timed(smoke.phase_build)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    da = smoke.denseattn
    routes = (("dense_attn (packed route)", da.dense_attention_fwd, da.dense_attention_bwd,
               smoke.K1_CASES, smoke.K1_F32_TOL),
              ("dense_attn (BHND route)", da.dense_attention_bhnd, da.dense_attention_bwd_bhnd,
               smoke.K3_CASES, smoke.K3_F32_O_TOL))
    for name, fwd, bwd, cases, tol in routes:
        for wide, iters in ((False, 10), (True, 3)):
            if WIDE_ONLY and not wide:
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
    for shape in WIDE_BREAKDOWN:
        _breakdown(dev, gen, routes[1][0], da.dense_attention_bhnd, da.dense_attention_bwd_bhnd,
                   shape)


if __name__ == "__main__":
    main()
