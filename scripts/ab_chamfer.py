"""Times the Chamfer kernels (K4 forward, K5 backward) of one checkout of
this repository on one CUDA card, three ways, so that two checkouts run
in one call compare by one method:

    python scripts/ab_chamfer.py [ROOT]

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` is the one imported; its kernels build into
ROOT/build/cuda on first use. For random normal clouds and skewed ones
(half of gt on 4 pred points: long inverse lists for K5), at N = 2048 and
the SetVAE (B = 64) and SetLRVAE (B = 16) batches, it prints:

  * device: 10 calls replayed from one CUDA graph between CUDA events,
    per call (every kernel the call launches, without the host's path);
  * back to back: CUDA events around 10 calls, divided by 10, median of
    3 runs: the device's time, or the host's where that is the longer;
  * host: the host's time a call, 200 calls without a synchronisation;
  * whether K4 equals its plain version bit for bit, and K5 the plain
    version run on the CPU (whose index_add adds in index order).

The device and back-to-back times are those of chip_smoke.py phase 3
(`_device_ms`, `_sync_ms`), taken from the chip_smoke.py beside this
script whatever ROOT is. The first line is the card's name and power
limit (nvidia-smi).
"""

import importlib.util
import os
import subprocess
import sys
import time

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else HERE)
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from vae_song_tpu_torch.ops import chamfer  # noqa: E402

_spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(HERE, "chip_smoke.py"))
smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(smoke)

N, SEED = 2048, 0


def _host_ms(fn, calls=200):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    ms = (time.perf_counter() - t0) / calls * 1e3
    torch.cuda.synchronize()
    return ms


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"checkout {ROOT}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    for inputs in ("random", "skewed"):
        for b in (64, 16):
            pred = torch.randn(b, N, 3, generator=gen, device=dev)
            gt = torch.randn(b, N, 3, generator=gen, device=dev)
            if inputs == "skewed":
                gt[:, : N // 2] = pred[:, :4].repeat(1, N // 8, 1) + 1e-3
            got = chamfer.chamfer_nn_packed(pred, gt)
            k4_equal = all(torch.equal(g.view(torch.int32), w.view(torch.int32))
                           for g, w in zip(got, chamfer.chamfer_nn_packed_plain(pred, gt)))
            _, argp, _, argg = got
            d = chamfer.chamfer_bwd(pred, gt, argp, argg)
            cpu = chamfer.chamfer_bwd_plain(pred.cpu(), gt.cpu(), argp.cpu(), argg.cpu())
            k5_equal = all(torch.equal(g.cpu(), c) for g, c in zip(d, cpu))
            for name, fn, equal in (
                ("K4", lambda: chamfer.chamfer_nn_packed(pred, gt), k4_equal),
                ("K5", lambda: chamfer.chamfer_bwd(pred, gt, argp, argg), k5_equal),
            ):
                print(f"{name} {inputs} B={b} N={N}: device {smoke._device_ms(fn):.4f} ms, back "
                      f"to back {smoke._sync_ms(fn, 10, 3):.4f} ms, host {_host_ms(fn):.4f} ms a call; "
                      f"bitwise equal to the plain version{' on the CPU' * (name == 'K5')}: "
                      f"{equal}", flush=True)


if __name__ == "__main__":
    main()
