"""Checks and times the f32 fused FFN kernels (K6f and K6b under
`mixed_precision: false`) of one checkout of this repository on one CUDA
card, by this checkout's chip_smoke.py, so that two checkouts run in one
call compare by one method:

    python scripts/ab_ffn_f32.py [ROOT]

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported and its kernels build into
ROOT/build/cuda. The checks are chip_smoke.py's: phase 1 (the card's name
and power limit), phase 2 (the build, with ptxas's register and spill
lines) and phase 3's `check_ffn` on each f32 case, one at a time (a case
that fails prints why, and the next case runs): K6_CASES' f32 case on
the grid inputs against the plain version, and K6_F32_CASES on inputs
whose products need the split against float64, no farther from it than
the plain version; each bitwise from run to run and timed beside the
split-TF32 and FMA bounds, the plain version and the unfused references.
Then the device time of each kernel of a forward and a backward call
(torch.profiler, 5 calls) at M = 8192 and M = 131072 (D = 256, F = 512),
and the train step's ms/step of the shipped SetVAE config under
`mixed_precision: false` with and without VST_FUSED_FFN=1. Run it on
parent, PR, PR, parent in one call.
"""

import collections
import importlib.util
import os
import sys
import types
from unittest import mock

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from vae_song_tpu_torch.ops import ffn  # noqa: E402

# A checkout from before the split-TF32 FFN kernels has no launch counters
# for them, which chip_smoke.py's COUNTERS name: give it idle ones, which
# nothing here reads.
for _name in ("tf32_fwd", "tf32_bwd"):
    if not hasattr(ffn, _name):
        setattr(ffn, _name, types.SimpleNamespace(launches=0))

_spec = importlib.util.spec_from_file_location("chip_smoke_checks",
                                               os.path.join(HERE, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

# the per-kernel breakdown's shapes (M, D, F): phase 3's f32 grid case and
# the f32 path's rows
BREAKDOWN = ((8192, 256, 512), smoke.K6_F32_PATH_CASE)


def _kernel_ms(fn, calls=5):
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


def _breakdown(dev, gen, m, d, f):
    x, dy, w1, b1, w2, b2 = smoke._ffn_inputs(m, d, f, torch.float32, gen, dev, mixed=True)
    for part, fn in (("fwd", lambda: ffn.fused_ffn_fwd(x, w1, b1, w2, b2)),
                     ("bwd", lambda: ffn.fused_ffn_bwd(x, dy, w1, b1, w2))):
        times = _kernel_ms(fn)
        print(f"fused_ffn M={m} D={d} F={f} float32 {part} device ms a call: "
              + "; ".join(f"{k[:90]} {t:.4f}" for k, t in sorted(times.items()))
              + f"; total {sum(times.values()):.4f}")


def main():
    print(f"root {ROOT}")
    smoke.phase_environment()
    dev = torch.device("cuda", 0)
    smoke._timed(smoke.phase_build)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    grid = tuple(c for c in smoke.K6_CASES if c[3] == torch.float32)
    cases = [((c,), ()) for c in grid] + [((), (c,)) for c in smoke.K6_F32_CASES]
    for k6, k6_f32 in cases:
        try:
            with mock.patch.object(smoke, "K6_CASES", k6), \
                    mock.patch.object(smoke, "K6_F32_CASES", k6_f32):
                smoke.check_ffn(dev, gen)
        except AssertionError as e:
            print(f"FAILED: {e}")
    for m, d, f in BREAKDOWN:
        _breakdown(dev, gen, m, d, f)
    params = dict(smoke.MODEL_PARAMS, mixed_precision=False)
    smoke._time_train_step("setvae", params, smoke.BATCH, dev, "f32")
    with mock.patch.dict(os.environ, smoke.FUSED_FFN_ENV):
        smoke._time_train_step("setvae", params, smoke.BATCH, dev, "f32 VST_FUSED_FFN=1")


if __name__ == "__main__":
    main()
