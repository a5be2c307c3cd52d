"""Times the attention forward (K1 on the packed route, K3f on the BHND
route) of one checkout of this repository on one CUDA card, three ways,
so that two checkouts run in one call compare by one method:

    python scripts/ab_attn_fwd.py [ROOT]

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported; its kernels build into
ROOT/build/cuda on first use. For each shape (bf16, N = 2048, the
main path's B = 64 and the decoder's batch-constant B = 1) it prints:

  * per call: CUDA events around one call, synchronised, median of 20:
    the device's time plus whatever of the host's launch path falls
    between the events;
  * back to back: events around 20 calls, divided by 20, median of 3:
    the host's launch path overlaps the device's work where the kernel
    is the longer;
  * device: the kernel time torch.profiler records for the forward's
    kernels (names containing dense_attn_fwd) over 20 calls, per call.

The first line is the card's name and power limit (nvidia-smi).
"""

import os
import statistics
import subprocess
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402

from vae_song_tpu_torch.ops import denseattn  # noqa: E402

CALLS = 20
# (route, B, H, D): the main path's shapes of each route and the decoder's
# batch-constant layer
CASES = (("K1", 64, 4, 64), ("K1", 1, 4, 64), ("K3f", 64, 2, 128), ("K3f", 64, 3, 64))
N = 2048


def _events_ms(fn, calls):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / calls


def _device_ms(fn):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA and "dense_attn_fwd" in e.name)
    return us / 1e3 / CALLS


def main():
    if not torch.cuda.is_available():
        raise RuntimeError("ab_attn_fwd.py needs a CUDA card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    print(f"checkout {ROOT}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for route, b, h, d in CASES:
        fwd = denseattn.dense_attention_fwd if route == "K1" else denseattn.dense_attention_bhnd
        q, k, v = ((torch.randn(b, N, h * d, generator=gen, device=dev) * s)
                   .to(torch.bfloat16).view(b, N, h, d) for s in (2.0, 2.0, 1.0))
        call = lambda: fwd(q, k, v, d ** -0.5)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        per_call = statistics.median(_events_ms(call, 1) for _ in range(CALLS))
        back_to_back = statistics.median(_events_ms(call, CALLS) for _ in range(3))
        print(f"{route} B={b} N={N} H={h} D={d} bf16: per call {per_call:.4f} ms, back to back "
              f"{back_to_back:.4f} ms, device {_device_ms(call):.4f} ms")


if __name__ == "__main__":
    main()
