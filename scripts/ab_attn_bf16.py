"""Checks and times the bf16 attention kernels for heads of 192 and 256
(K3f/K3b on the BHND route) of one checkout of this repository on one
CUDA card, by this checkout's chip_smoke.py, so that two checkouts run in
one call compare by one method:

    python scripts/ab_attn_bf16.py [ROOT] [--wider | --cluster [--dq-cluster] | --scores]
    python scripts/ab_attn_bf16.py --scores-narrow

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported and its kernels build into
ROOT/build/cuda. The checks are chip_smoke.py's: phase 1 (the card's name
and power limit), phase 2 (the build, with ptxas's register and spill
lines) and phase 3's `check_attention` on every bf16 case of the BHND
route at D = 192 and 256 (the bf16 num_heads 1 path's B = 64, D = 256,
two heads of 192, N = 192 and B = 1; runs of 10 calls): each at
chip_smoke.py's bounds against the plain version and bitwise from run to
run (a case that fails prints why, and the next case runs), timed beside
the bound, the plain version and SDPA's bf16 call. Then the device time a
call of each of the forward's and the backward's kernels takes
(torch.profiler, 10 calls) at B = 64, N = 2048 with one head of 256 and
with two of 192, and at B = 1 with one head of 256.

With --wider the same for the bf16 heads of 320 to 512 instead: phase
3's cases at those widths (the d_model 512, num_heads 1 path's B = 64,
D = 512, its decoder's B = 1, B = 8 at D = 320 and 512), then the device
time of each kernel at those four shapes. To hold a change against its
parent, run both checkouts in one call, parent, change, change, parent.

With --cluster the same for the bf16 heads of 576 to 2048 (the cluster
kernels; in a checkout from before them, the mma.sync column-chunk
kernels): phase 3's cases at those widths (the d_model 768, num_heads 1
path's B = 64, D = 768, its decoder's B = 1, N = 192, B = 8 at D = 576
and 1024, B = 2 at D = 1600), then the device time of each kernel at B =
8 with D = 576 and 1024 and at B = 64 and B = 1 with D = 768. With
--dq-cluster as well (ROOT must be this checkout) it then times, at those
four shapes, the backward whose dQ kernel recomputes S and dP over the
cluster and sums them there (scripts/ab_attn_dq_cluster.cu, 14 B H N^2 D)
against the package's, whose dQ kernel reads the dK/dV kernel's dS^T (10
B H N^2 D), in turns (package, variant, variant, package), after
checking that the two give the same bits, and each one's device time.

With --scores the same for the bf16 heads wider than 2048 (the kernels
over written-out scores; in a checkout from before them, the mma.sync
column-chunk kernels): phase 3's cases at those widths (the d_model 2304,
num_heads 1 path's B = 64, D = 2304, its decoder's B = 1, N = 192 and B
= 8 at D = 2112, B = 2 with two heads of 2176, B = 1 at D = 4096) and B
= 8 at D = 2304, then the device time of each kernel at B = 8 with D =
2112 and 2304 and at B = 64 with D = 2304.

With --scores-narrow (this checkout only, alone) it checks and times, at
B = 8 and 64 with heads of 1024 and 2048, the kernels over written-out
scores (entry points of scripts/ab_attn_scores.cu, which run them at any
width) beside the package's cluster kernels there, in turns (package,
variant, variant, package; runs of 10 calls), each held to the plain
version at chip_smoke.py's bf16 bounds (the two designs round P against
different maxima, so their bits differ).

With --dup (ROOT must be this checkout) it also times, at those three
shapes, the backward whose dK/dV kernel has both warpgroups compute S^T
and dP^T over the whole head (scripts/ab_attn_bwd_dup.cu, 18 B H N^2 D)
against the package's, whose warpgroups split them (14 B H N^2 D), in
turns (package, variant, variant, package; chip_smoke.py's `_sync_ms`,
runs of 10 calls), after checking that the two give the same bits.
"""

import collections
import ctypes
import hashlib
import importlib.util
import math
import os
import subprocess
import sys
import types

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGS = ("--dup", "--wider", "--cluster", "--dq-cluster", "--scores", "--scores-narrow")
ARGS = [a for a in sys.argv[1:] if a not in FLAGS]
ROOT = os.path.abspath(ARGS[0] if ARGS else HERE)
DUP = "--dup" in sys.argv[1:]
WIDER = "--wider" in sys.argv[1:]
CLUSTER = "--cluster" in sys.argv[1:]
DQ_CLUSTER = "--dq-cluster" in sys.argv[1:]
SCORES = "--scores" in sys.argv[1:]
SCORES_NARROW = "--scores-narrow" in sys.argv[1:]
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from vae_song_tpu_torch import _kernels  # noqa: E402
from vae_song_tpu_torch.ops import denseattn  # noqa: E402

# A checkout from before the wgmma kernels for bf16 heads of 192 and wider
# has no launch counters for them, which chip_smoke.py's COUNTERS name:
# give it idle ones, which nothing here reads.
for _name in ("wgmma_wide_fwd", "wgmma_wide_bwd", "wgmma_wider_fwd", "wgmma_wider_bwd",
              "wgmma_cluster_fwd", "wgmma_cluster_bwd", "wgmma_scores_fwd", "wgmma_scores_bwd"):
    if not hasattr(denseattn, _name):
        setattr(denseattn, _name, types.SimpleNamespace(launches=0))
# ... nor, from before the kernels over written-out scores, their rule,
# which chip_smoke.py's label of the operations executed reads
if not hasattr(denseattn, "wgmma_scores"):
    denseattn.wgmma_scores = lambda dtype, d: False

_spec = importlib.util.spec_from_file_location("chip_smoke_checks",
                                               os.path.join(HERE, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

BREAKDOWN = ((smoke.BATCH, smoke.NPTS, 1, 256), (smoke.BATCH, smoke.NPTS, 2, 192),
             (1, smoke.NPTS, 1, 256))
# --wider: the heads of 320 to 512 (the d_model 512, num_heads 1 path's
# B = 64 and its decoder's B = 1 at 512, B = 8 at 320 and 512)
WIDER_BREAKDOWN = ((8, smoke.NPTS, 1, 320), (8, smoke.NPTS, 1, 512),
                   (smoke.BATCH, smoke.NPTS, 1, 512), (1, smoke.NPTS, 1, 512))
# --cluster: the heads of 576 to 2048 (B = 8 at 576 and 1024, the d_model
# 768, num_heads 1 path's B = 64 and its decoder's B = 1 at 768)
CLUSTER_BREAKDOWN = ((8, smoke.NPTS, 1, 576), (8, smoke.NPTS, 1, 1024),
                     (smoke.BATCH, smoke.NPTS, 1, 768), (1, smoke.NPTS, 1, 768))
# --scores: the heads wider than 2048 (B = 8 at 2112 and 2304, the d_model
# 2304, num_heads 1 path's B = 64)
SCORES_BREAKDOWN = ((8, smoke.NPTS, 1, 2112), (8, smoke.NPTS, 1, 2304),
                    (smoke.BATCH, smoke.NPTS, 1, 2304))
# --scores-narrow: the kernels over written-out scores beside the cluster
# kernels at heads the package sends to the cluster
NARROW_SHAPES = ((8, smoke.NPTS, 1, 1024), (8, smoke.NPTS, 1, 2048),
                 (smoke.BATCH, smoke.NPTS, 1, 1024), (smoke.BATCH, smoke.NPTS, 1, 2048))


def _kernel_ms(fn, calls=10):
    """Device ms a call of each CUDA kernel fn() launches, by kernel name."""
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


def _breakdown(dev, gen, shape):
    b, n, h, d = shape
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, n, h, d, torch.bfloat16, gen, dev)
    do = torch.randn(b, n, h, d, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = denseattn.dense_attention_bhnd(q, k, v, scale)
    for part, fn in (("fwd", lambda: denseattn.dense_attention_bhnd(q, k, v, scale)),
                     ("bwd", lambda: denseattn.dense_attention_bwd_bhnd(q, k, v, o, lse, do,
                                                                        scale))):
        times = _kernel_ms(fn)
        print(f"BHND B={b} N={n} H={h} D={d} bfloat16 {part} device ms a call: "
              + "; ".join(f"{k_[:90]} {t:.4f}" for k_, t in sorted(times.items()))
              + f"; total {sum(times.values()):.4f}")


def _variant_library(name="ab_attn_bwd_dup", kernel="dkdv_dup_kernel",
                     entry="vst_ab_attn_bwd_dup", like="vst_dense_attn_bwd"):
    """Compile scripts/<name>.cu (with the package's flags) into
    build/<name>/ unless built for these sources, print ptxas's lines for
    its kernels named `kernel`, and load it; its entry point `entry` takes
    the arguments of the package's entry point `like`."""
    src = os.path.join(HERE, "scripts", f"{name}.cu")
    h = hashlib.sha256(open(src, "rb").read())
    for dep in sorted(_kernels.CSRC.iterdir()):
        h.update(dep.read_bytes())
    out = os.path.join(ROOT, "build", name)
    so = os.path.join(out, f"{name}_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(out, exist_ok=True)
        # the included source calls the f32 kernels for wide heads and the
        # bf16 kernels above 2048: link them too
        deps = [str(_kernels.CSRC / f) for f in ("dense_attn_tf32_wide.cu",
                                                 "dense_attn_scores.cu")]
        built = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-shared", "-o", so, src,
                                *deps], capture_output=True, text=True, check=False)
        lines = (built.stdout + built.stderr).splitlines()
        for i, line in enumerate(lines):
            if kernel in line and "Compiling" in line:
                print("  ptxas:", " | ".join(x.strip() for x in lines[i:i + 3]))
        if built.returncode != 0:
            raise SystemExit(f"nvcc failed for scripts/{name}.cu:\n" + "\n".join(lines))
    lib = ctypes.CDLL(so)
    sig = _kernels._SIGNATURES[like]
    fn = getattr(lib, entry)
    # the dup variant takes the entry point's arguments before its dS^T
    # scratch (argument 9) was added
    fn.argtypes = sig[:9] + sig[10:] if name == "ab_attn_bwd_dup" else sig
    fn.restype = ctypes.c_int
    return fn


def _bwd_variant(fn, q, k, v, o, lse, do, scale):
    """denseattn._launch_bwd with a variant's entry point `fn`."""
    b, n, h, d = q.shape
    o, do, lse = o.contiguous(), do.contiguous(), lse.float().contiguous()
    dq, dk, dv = (torch.empty_like(o) for _ in range(3))
    delta = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    qc = torch.empty_like(o)
    # dS^T scratch: none for the dup variant, P^T and dS^T for the kernels
    # over written-out scores
    tiles = 2 if fn.__name__ == "vst_ab_attn_scores_bwd" else 1
    ds = ([] if fn.__name__ == "vst_ab_attn_bwd_dup"
          else [torch.empty((tiles * b * h, n, n), dtype=torch.bfloat16,
                            device=q.device).data_ptr()])
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
             lse.data_ptr(), delta.data_ptr(), qc.data_ptr(), *ds, dq.data_ptr(), dk.data_ptr(),
             dv.data_ptr(), b, h, n, d, sb, sn, sh, ob, on, oh, float(scale * denseattn.LOG2E),
             float(scale), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return dq, dk, dv


def _fwd_variant(fn, q, k, v, scale):
    """denseattn._launch_fwd with the entry point `fn` of the kernels over
    written-out scores."""
    b, n, h, d = q.shape
    o = torch.empty((b, n, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    scratch = torch.empty(denseattn.scores_fwd_scratch_bytes(b, h, n, d), dtype=torch.uint8,
                          device=q.device)
    sb, sn, sh, _ = q.stride()
    ob, on, oh, _ = o.stride()
    err = fn(1, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
             scratch.data_ptr(), b, h, n, d, sb, sn, sh, ob, on, oh,
             float(scale * denseattn.LOG2E), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__}: CUDA error {err}")
    return o, lse


def _scores_narrow_arm(dev, gen, fwd_fn, bwd_fn, shape):
    """The package's cluster kernels against the kernels over written-out
    scores at `shape`: each held to the plain version at chip_smoke.py's
    bf16 bounds, then forward and backward timed in turns (package,
    variant, variant, package), runs of 10 calls."""
    b, n, h, d = shape
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, n, h, d, torch.bfloat16, gen, dev)
    do = torch.randn(b, n, h, d, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = denseattn.dense_attention_bhnd(q, k, v, scale)
    names = ("cluster kernels", "kernels over written-out scores")
    fwd = {names[0]: lambda: denseattn.dense_attention_bhnd(q, k, v, scale),
           names[1]: lambda: _fwd_variant(fwd_fn, q, k, v, scale)}
    bwd = {names[0]: lambda: denseattn.dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale),
           names[1]: lambda: _bwd_variant(bwd_fn, q, k, v, o, lse, do, scale)}
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, scale)
    want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
    ok = True
    for name in names:
        got_o, got_lse = fwd[name]()
        grads = bwd[name]()
        ratios = [smoke._max_err(got_o, o_ref)
                  / (smoke.K1_BF16_O_TOL * max(1.0, float(o_ref.float().abs().max()))),
                  smoke._max_err(got_lse, lse_ref)
                  / (smoke.K1_BF16_LSE_TOL * max(1.0, float(lse_ref.abs().max())))]
        ratios += [smoke._max_err(g_, w_) / (smoke.K2_BF16_TOL * float(w_.float().abs().max()))
                   for g_, w_ in zip(grads, want)]
        ok = ok and max(ratios) <= 1.0
        print(f"BHND B={b} N={n} H={h} D={d} bfloat16 {name}: error over bound O, LSE, dq, dk, "
              f"dv {', '.join(f'{r:.3f}' for r in ratios)}")
    for part, arms in (("fwd", fwd), ("bwd", bwd)):
        ms = {name: [] for name in names}
        for name in (names[0], names[1], names[1], names[0]):
            ms[name].append(smoke._sync_ms(arms[name], 10))
        print(f"BHND B={b} N={n} H={h} D={d} bfloat16 {part}, "
              + ", ".join(f"{name} {', '.join(f'{t:.4f}' for t in ms[name])} ms"
                          for name in names))
    if not ok:
        raise AssertionError(f"a design misses the plain version's bounds at {shape}")


def _variant_arm(dev, gen, fn, shape, names, device=False):
    """The package's backward (names[0]) against the variant `fn`
    (names[1]) at `shape`: bitwise equal, then in turns (package, variant,
    variant, package), runs of 10 calls; with `device`, each one's device
    time a call by kernel too."""
    b, n, h, d = shape
    scale = 1.0 / math.sqrt(d)
    q, k, v = smoke._attn_inputs(b, n, h, d, torch.bfloat16, gen, dev)
    do = torch.randn(b, n, h, d, generator=gen, device=dev).to(torch.bfloat16)
    o, lse = denseattn.dense_attention_bhnd(q, k, v, scale)
    arms = {names[0]: lambda: denseattn.dense_attention_bwd_bhnd(q, k, v, o, lse, do, scale),
            names[1]: lambda: _bwd_variant(fn, q, k, v, o, lse, do, scale)}
    same = all(torch.equal(a, b_) for a, b_ in zip(arms[names[0]](), arms[names[1]]()))
    ms = {name: [] for name in arms}
    for name in (names[0], names[1], names[1], names[0]):
        ms[name].append(smoke._sync_ms(arms[name], 10))
    print(f"BHND B={b} N={n} H={h} D={d} bfloat16 bwd, "
          + ", ".join(f"{name} {', '.join(f'{t:.4f}' for t in ms[name])} ms" for name in names)
          + f"; bitwise equal {same}")
    if device:
        for name in names:
            times = _kernel_ms(arms[name])
            print(f"  {name} device ms a call: "
                  + "; ".join(f"{k_[:90]} {t:.4f}" for k_, t in sorted(times.items()))
                  + f"; total {sum(times.values()):.4f}")
    if not same:
        raise AssertionError(f"the two backward variants differ at {shape}")


def main():
    print(f"root {ROOT}")
    smoke.phase_environment()
    dev = torch.device("cuda", 0)
    smoke._timed(smoke.phase_build)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    if SCORES_NARROW:
        if ROOT != HERE:
            raise SystemExit("--scores-narrow times this checkout's kernels only")
        fwd_fn, bwd_fn = (_variant_library("ab_attn_scores", "attn_scores_kernel",
                                           f"vst_ab_attn_scores_{part}", f"vst_dense_attn_{part}")
                          for part in ("fwd", "bwd"))
        for shape in NARROW_SHAPES:
            _scores_narrow_arm(dev, gen, fwd_fn, bwd_fn, shape)
        return
    widths = ((lambda d: d > 2048) if SCORES else (lambda d: 512 < d <= 2048) if CLUSTER
              else (lambda d: 256 < d <= 512) if WIDER else (lambda d: d in (192, 256)))
    extra = ((8, smoke.NPTS, 1, 2304, torch.bfloat16),) if SCORES else ()
    for case in smoke.K3_CASES + extra:
        if case[4] == torch.bfloat16 and widths(case[3]):
            try:
                smoke.check_attention(dev, gen, "dense_attn (BHND route)",
                                      denseattn.dense_attention_bhnd,
                                      denseattn.dense_attention_bwd_bhnd, (case,),
                                      smoke.K3_F32_O_TOL)
            except AssertionError as e:
                print(f"FAILED: {e}")
    for shape in (SCORES_BREAKDOWN if SCORES else CLUSTER_BREAKDOWN if CLUSTER
                  else WIDER_BREAKDOWN if WIDER else BREAKDOWN):
        _breakdown(dev, gen, shape)
    if DUP or DQ_CLUSTER:
        if ROOT != HERE:
            raise SystemExit("--dup and --dq-cluster time this checkout's kernels only")
    if DUP:
        fn = _variant_library()
        for shape in BREAKDOWN:
            _variant_arm(dev, gen, fn, shape, ("split scores (14 B H N^2 D)",
                                               "both warpgroups computing the scores "
                                               "(18 B H N^2 D)"))
    if DQ_CLUSTER:
        fn = _variant_library("ab_attn_dq_cluster", "cluster_kernel",
                              "vst_ab_attn_bwd_dq_cluster")
        for shape in CLUSTER_BREAKDOWN:
            _variant_arm(dev, gen, fn, shape, ("dQ from dS^T (10 B H N^2 D)",
                                               "dQ on the cluster (14 B H N^2 D)"), device=True)


if __name__ == "__main__":
    main()
