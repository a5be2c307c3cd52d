"""Times the SetVAE train step of one checkout of this repository on one
CUDA card, before and after chip_smoke.py's phase 3 kernel checks in the
same process, so that two checkouts run in one call compare by one
method and a change in the step's time after those checks shows:

    python scripts/ab_train_step.py [ROOT]

ROOT (default: this checkout) is put first on sys.path, so its
`vae_song_tpu_torch` and its chip_smoke.py are the ones imported; its
kernels build into ROOT/build/cuda on first use. The step is chip_smoke's
`_time_train_step` (the shipped SetVAE config, B = 64, N = 2048, bf16;
median of 5 steps after 2 warm-up steps, host clock, each step ending in
a scalar fetch), three times at the start and three times after each of
phase 3's checks (K1/K2, K3f/K3b, K4, K5, K6f/K6b, then eval and
generation). It prints one line per point, with the six medians: the
first line is the card's name and power limit (nvidia-smi).
"""

import contextlib
import io
import os
import sys

ROOT = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from vae_song_tpu_torch.ops import denseattn  # noqa: E402


def main():
    smoke.phase_environment()
    with contextlib.redirect_stdout(io.StringIO()):
        smoke.phase_build()
    print(f"checkout {ROOT}")
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(smoke.SEED)
    checks = (
        ("K1/K2", lambda: smoke.check_attention(
            dev, gen, "packed", denseattn.dense_attention_fwd, denseattn.dense_attention_bwd,
            smoke.K1_CASES, smoke.K1_F32_TOL)),
        ("K3f/K3b", lambda: smoke.check_attention(
            dev, gen, "bhnd", denseattn.dense_attention_bhnd, denseattn.dense_attention_bwd_bhnd,
            smoke.K3_CASES, smoke.K3_F32_O_TOL)),
        ("K4", lambda: smoke.check_chamfer(dev, gen)),
        ("K5", lambda: smoke.check_chamfer_bwd(dev, gen)),
        ("K6f/K6b", lambda: smoke.check_ffn(dev, gen)),
        ("eval and generation", lambda: smoke.phase_eval_generation(dev)),
    )
    for name, check in (("start", None), *checks):
        if check is not None:
            with contextlib.redirect_stdout(io.StringIO()):
                check()
        with contextlib.redirect_stdout(io.StringIO()):
            ms = [smoke._time_train_step("setvae", smoke.MODEL_PARAMS, smoke.BATCH, dev)
                  for _ in range(3)]
        print(f"SetVAE train step, {'at the start' if check is None else 'after ' + name}: "
              + ", ".join(f"{m:.3f}" for m in ms) + " ms/step", flush=True)


if __name__ == "__main__":
    main()
