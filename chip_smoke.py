"""Smoke run of the PyTorch port (vae_song_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a
non-zero exit code:

  1. environment: a CUDA card is required; prints its name and power
     limit (nvidia-smi) and turns TF32 off.
  2. build: compiles the kernels from vae_song_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card
     at the shapes its path gives it, with the stated bounds, the median
     time of both (runs of back-to-back calls; for the Chamfer kernels,
     whose calls are about as short as the host's launch path, also the
     device time of calls replayed from a CUDA graph, as `device_ms`),
     the least time the card could take (the bound) and,
     where one PyTorch call computes the same function, that call's
     time: attention forward and backward on the packed route (K1, K2)
     and on the BHND route (K3f, K3b), Chamfer forward (K4, one launch
     for both sides, bitwise equal to its plain version) and backward (K5,
     on random clouds and on skewed ones, also bitwise equal to its plain
     version run on the CPU), the fused FFN forward (K6f) and backward
     (K6b), each also at the widths its route takes past the shipped
     config (heads of 320 and 512, FFN widths of 384 and 512); K1, K2,
     K4 and K5 also at phase 8's microbatch of 32 clouds. No kernel
     uses floating-point atomics: a second call on the same inputs must
     give the same bits. Beside the fused FFN the unfused Dense -> ReLU -> Dense
     (forward, and forward + backward) and, forward only (PyTorch has no
     backward for it), cuBLASLt's bias + ReLU epilogue
     (`torch._addmm_activation`, then `addmm` and the residual add) are
     timed as references.
  4. eval and generation: the shipped ShapeNet SetVAE config at full
     width (B = 64 clouds of N = 2048 points, bf16), random weights from
     a seed: the eval step on 4 batches after a warm-up, then generation
     of 4 batches of 64 clouds. The K1 and K4 launch counters must rise.
  4b. training, the main path: `train_and_test` on the shipped SetVAE
     config (fake clouds: 256 train, 64 test, so 4 steps an epoch), 2
     epochs into a temporary directory; every loss term finite, the
     artifacts written, and the K1, K2, K4 and K5 launch counters must
     all rise. Then ms/step of `make_train_step` for SetVAE (B = 64) and
     SetLRVAE (its config's B = 16) on the host clock.
  4c. the two further paths at full width: (1) the shipped SetVAE config
     with `num_heads: 2` (head width 128, the BHND route): one fake-data
     epoch of `train_and_test`, then the eval step's ms/batch and the
     train step's ms/step; the K3f and K3b counters must rise and K1 and
     K2 must not launch. (2) the shipped SetVAE and SetLRVAE configs with
     VST_FUSED_FFN=1 (set and unset here): the train step's ms/step and
     the eval step's ms/batch; the K6f and K6b counters must rise.
  4d. routes: the shipped SetVAE eval step at full width once under each
     of the JAX package's attention switches (VST_DISABLE_DENSE_ATTN=1,
     VST_DENSE_ATTN_PACKED=0, VST_FUSED_QKV=1), the launch counters
     showing which attention kernels ran and the loss terms within the
     bf16 reference bound of the default route's; then a Chamfer call at
     B = 12, which the packed kernel's gate refuses: no K4 launch and the
     exact tiled value.
  5. reference: the same weights on the CPU (plain versions of the
     kernels) against the card on 2 clouds, in f32 and in bf16: the eval
     step, the decode, and one train step (loss terms, gradients and the
     updated parameters), for the shipped SetVAE config and for both
     configurations of phase 4c.
  6. the DeepSets SetVAE: the shipped SetVAE config with `use_attention:
     false` (the MLP encoder and decoder with BatchNorm at the config's
     encoder_hidden / decoder_hidden widths, B = 64, N = 2048, f32): the
     train step's ms/step, the eval step's ms/batch and generation
     clouds/s, the K4 and K5 counters rising and no other kernel; then the
     card against the CPU on the same weights and 8 clouds (the Chamfer
     kernels' gate takes 8): one train step's loss terms, gradients,
     updated parameters and BatchNorm running statistics, for SetVAE and
     SetLRVAE (whose encoder statistics move twice a step).
  7. attention dropout: the shipped SetVAE config with `attn_dropout: 0.1`:
     train steps with masks from a CUDA generator (ms/step and peak device
     memory; at B = 64, or B = 32 if the materialised [B, 4, N, N] scores
     do not fit), during which K1 and K2 must not launch (training dropout
     materialises the scores, as JAX does), then the eval step, which must
     launch K1 (the decoder's first layer then runs at full batch); then
     the card against the CPU, the same keep masks injected into both, at
     a reduced size (8 clouds of 256 points), f32 and bf16.
  8. trainer options: `train_and_test` on the shipped SetVAE config at
     full width on fake clouds for 2 epochs with `checkpoint_every: 1`,
     `async_checkpoint: true` and `grad_accum: 2` (microbatches of 32,
     which run K1, K2, K4 and K5), the train step's ms/step under
     grad_accum 2; then a fresh model resumed from `ckpt_0.pkl`, whose
     final parameters, statistics and optimizer state must equal the
     continuous run's bit for bit.

  9. the FlexibleVAE family, which runs no kernel of the port (JAX runs it
     through XLA alone): the shipped pinwheel config (LR-VAE, twelve
     blocks of 16, B = 1024, both sweep points) through `run_experiment`
     for 3 epochs instead of its 1000, every term finite and the tree
     written; the train step's ms/step of the pinwheel LR-VAE, of the
     MNIST config's MLP LR-VAE (B = 256, L = 4, on seeded images of
     MNIST's shape) and of the JAX benchmark's conv VAE (bench.py:72,
     B = 256, f32), with its eval ms/batch, all timed before the first
     torch.profiler session opens, then each one's idle share
     (torch.profiler); then the card against the CPU for one staged
     LR-VAE step and one conv VanillaVAE step, in f32 and in float64, the
     card's f32 step held to the CPU's float64 step on the same LeakyReLU
     pieces; the conv step with cuDNN's TF32 switched back to PyTorch's
     default (on), which the port's f32 convolutions must override, and
     once more with that override off, which must fail the f32 bound. No
     kernel counter may rise on any of these.
  10. LID-VAE and the Lipschitz analysis, no kernel of the port either:
     cli/lipschitz.main on the card for LR-VAE and LIDVAE at the CLI's full
     data size and grids (10000 points, K = K_z = 16, 2000 pairs a cell,
     5000 data-based pairs) for 3 epochs instead of 1000, the CSVs and
     finite metrics asserted, with each one's s/epoch, analysis wall time
     and peak device memory; the card's analysis fields held to the CPU's
     on the same weights and draws (2000 points, 4 x 4 grids); the LIDVAE
     train step's ms/step and idle share at the CLI's width and at MNIST's
     (conv encoder, latent 32, B = 256), and each held to the CPU's float64
     step on the card's LeakyReLU pieces. No kernel counter may rise.

The kernels' JSON line reports, for each kernel, its launches on the
path that runs it (phase 4b for K1, K2, K4, K5; 4c for K3f, K3b, K6f,
K6b), the numbers phase 3 measured and the bound it computed, and under
`paths` its launches on each path of phases 6-10 (zero on phases 9 and
10). The
last two lines are that JSON line and the result line.
"""

import contextlib
import copy
import gc
import json
import math
import os
import statistics
import subprocess
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.cli import lipschitz as lipschitz_cli
from vae_song_tpu_torch.cli.generate import generate_samples
from vae_song_tpu_torch.cli.main import run_experiment
from vae_song_tpu_torch.data import load_dataset, native
from vae_song_tpu_torch.data.pipeline import num_batches
from vae_song_tpu_torch.data.shapenet import fake_point_clouds
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn import blocks
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.ops import chamfer, denseattn, ffn, inception
from vae_song_tpu_torch.ops import fid as fid_lib
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train import loop as train_loop
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import adam_state, make_optimizer
from vae_song_tpu_torch.train.steps import (make_accum_train_step, make_apply_fns,
                                             make_eval_step, make_train_step)

# literal copy of configs/config_shapenet_setvae.yaml's model_params
# (tests/test_torch_isolation.py holds it to the file)
MODEL_PARAMS = {
    "beta_list": [0.001],
    "latent_channel": 128,
    "num_points": 2048,
    "encoder_hidden": [128, 256, 512],
    "decoder_hidden": [512, 256, 128],
    "pool_type": "max",
    "num_mc_samples": 1,
    "residual_connection": False,
    "hchans": [],
    "use_attention": True,
    "d_model": 256,
    "num_heads": 4,
    "num_encoder_layers": 2,
    "num_decoder_layers": 2,
    "ff_dim": 512,
    "attn_dropout": 0.0,
    "mixed_precision": True,
}
# literal copy of the same file's common_params (held to it by the same test)
COMMON_PARAMS = {
    "niter": 1,
    "exp_epochs": 100,
    "batch_size": 64,
    "exp_data": "shapenet",
    "logfilename": "log_setvae.csv",
    "resultname": "result_setvae",
    "grad_clip": None,
    "dataset_params": {
        "shapenet_root": "dataset/shapenet",
        "category": None,
        "num_points": 2048,
    },
}
# configs/config_shapenet_setlrvae.yaml: MODEL_PARAMS with these keys, and
# its batch size (held to the file by the same test)
SETLRVAE_PARAMS = {"alpha_list": [0.1], "beta_list": [0.2], "wu_strat": "linear"}
SETLRVAE_BATCH = 16
# Phase 4c's configurations: the shipped configs with one override each
# (held to the files by the same test). HEADS2_OVERRIDE gives 128-wide
# heads, which the packed attention route refuses; FUSED_FFN_ENV is the
# JAX package's opt-in switch for the fused FFN.
HEADS2_OVERRIDE = {"num_heads": 2}
FUSED_FFN_ENV = {"VST_FUSED_FFN": "1"}
# Phases 6-8's configurations: the shipped SetVAE config with one override
# each (held to the file by the same test): the DeepSets encoder and decoder
# at the config's encoder_hidden / decoder_hidden widths, and attention
# dropout; and the trainer options of phase 8.
DEEPSETS_OVERRIDE = {"use_attention": False}
DROPOUT_OVERRIDE = {"attn_dropout": 0.1}
TRAINER_OPTIONS = {"checkpoint_every": 1, "async_checkpoint": True, "grad_accum": 2}
BATCH = COMMON_PARAMS["batch_size"]
# phase 7: the train step's batch, then the one to fall back to if the
# materialised scores of four attention layers do not fit the card
DROPOUT_BATCHES = (BATCH, BATCH // 2)
DROPOUT_STEPS = 3
# the card-vs-CPU checks of phases 6 and 7: 8 clouds (the packed Chamfer
# kernels' gate takes B % 8 == 0), of 256 points for dropout (the CPU
# computes [B, H, N, N] scores)
REF_CLOUDS = 8
DROPOUT_REF_POINTS = 256
EVAL_BATCHES = 4
GEN_BATCHES = 4
TRAIN_EPOCHS = 2
TIMED_STEPS = 5
LR = 1e-2           # train_and_test's lr, the reference's Adam(lr=1e-2)
SEED = 0

# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense):
# bf16 tensor cores, float32 outside the tensor cores (no TF32 is used),
# HBM3 bandwidth. A kernel's bound is the larger of its operations over
# the peak of their type and its bytes (each input read once, each output
# written once) over the bandwidth.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

# Bounds of kernel against plain version on the same inputs.
# bf16 attention: the kernel rounds P to bf16 against the running row
# max, the plain version against the final one, so single P entries
# differ by <= 1 bf16 ulp (2^-8 relative) and O by about one output ulp;
# bound: 2^-6 of max(1, max|O|). LSE is f32 from the same P: 1e-3 of
# max(1, max|LSE|). The same for both routes and every head width: the
# wider heads only lengthen the f32 sums.
K1_BF16_O_TOL = 2.0 ** -6
K1_BF16_LSE_TOL = 1e-3
# f32 attention: same math, summation order only.
K1_F32_TOL = 1e-5
# The BHND route's f32 O, measured at D = 128 (H100): 4.05e-5 at max|O|
# 4.35 (9.3e-6 relative) against the plain version. The base-2 scores
# reach |S2| ~ 36, where an f32 ulp is 3.8e-6, and a 128-term dot product
# in another order lands a few ulps away; exp2 turns 1e-5 on S2 into
# 7e-6 relative on P and on O. So the bound is 3e-5 of max(1, max|O|),
# not K1's 1e-5, which this route meets with no margin.
K3_F32_O_TOL = 3e-5
# Chamfer: identical d2 bits (no FMA contraction on either side), so the
# packed keys, hence mins and argmins, must be bitwise equal.
K4_TOL = 0.0
# Reference phase, card vs CPU on the same weights and inputs. f32:
# matmul summation order and the kernel's online softmax; the Chamfer
# kernel's min truncation (<= 2^-12 relative) dominates the loss terms.
REF_F32_LOSS_RTOL = 1e-3
REF_F32_RECON_ATOL = 1e-3
# bf16: GEMMs round their outputs to bf16 on both sides, at different
# points of different summation orders, through 4 post-norm layers each
# way; on the CPU the same comparison against the JAX package measured
# 1.3e-3 relative on the loss terms and 0.015 on recon.
REF_BF16_LOSS_RTOL = 2e-2
REF_BF16_RECON_ATOL = 0.1
# Reference train step (one Adam step at lr 1e-2 from the same weights):
# the gradient's relative L2 difference, and the share of parameter
# elements whose updates differ by more than lr/10 (Adam's first step is
# ~lr * sign(g), so a small gradient of another sign moves an element
# the other way). Measured (H100): f32 gradient 6.3e-4, share 3.7e-4;
# bf16 gradient 1.3e-2, share 1.1e-2. The largest single difference is
# printed but not bounded: one Adam step moves an element by at most lr,
# so it cannot exceed 2 lr and a bound on it could not fail.
REF_F32_GRAD_RTOL = 1e-2
REF_F32_MOVED_SHARE = 2e-3
REF_BF16_GRAD_RTOL = 0.1
REF_BF16_MOVED_SHARE = 5e-2
# BatchNorm running statistics after one train step, card against CPU: the
# same f32 batch statistics summed in other orders (the DeepSets step);
# bound 1e-4 of max(1, max|stat|).
REF_BN_TOL = 1e-4
# Attention backward, kernel against plain version on the same inputs.
# bf16: the tensor cores and the plain f32 einsum sum S and dP in other
# orders, so a rounded exp2 argument or dP can land one bf16 ulp apart;
# dq/dk/dv round to bf16 at the end (measured: one output ulp, 0.031 at
# max|d| ~ 10); bound 2^-6 of max|d|. f32: summation order only
# (measured 1.2e-5 at max|d| ~ 16); bound 1e-5 of max|d|. Both routes.
K2_BF16_TOL = 2.0 ** -6
K2_F32_TOL = 1e-5
# f32 heads wider than 256, backward: S2 and dP^T are sums of D products,
# which the kernel adds in column order and the plain version in blocked
# order; at D = 512 a few ulps on |S2| ~ 36 (ulp 3.8e-6) come through the
# exp2 into P and dS (measured, H100: 1.25e-5 of max|dV| at B = 1, N = 256,
# against 1e-5): bound 3e-5 of max|d|, K3_F32_O_TOL's reasoning for O.
K3_F32_WIDE_TOL = 3e-5
# Chamfer backward: the same f32 terms; the plain version's index_add
# adds with atomics in another order on the card (measured 3.6e-12 at
# max|d| 5e-5); bound 1e-6 of max|d|. On the CPU index_add adds in
# ascending index order, the kernel's order, so there the two are held
# bitwise equal (B N is a power of two, so the divisions agree too).
K5_TOL = 1e-6
# Fused FFN, kernel against plain version. The inputs lie on a coarse
# grid (x, dy in steps of 1/8, the weights in steps of 1/256, b1 in steps
# of 1/2048), so x W1 + b1 and dy W2^T are exact in f32 in any summation
# order and both sides see the same ReLU mask (on random f32 inputs an
# h32 within the summation error of 0 flips its mask and moves a whole
# column of dW1). What is left is the order of the later f32 sums before
# each output's one rounding: bf16 2^-6 of max|out| (two output ulps),
# f32 1e-5 of max|out|, as for the attention kernels. Measured (H100):
# 0, bitwise, in both dtypes.
K6_BF16_TOL = 2.0 ** -6
K6_F32_TOL = 1e-5

# shapes of phase 3 for each attention route: (B, N, H, D, dtype); the
# first is the shape its main path gives it, the JSON line reports it.
# B = 1 is the decoder's batch-constant layer; N = 192, an odd number of
# 64-row tiles, puts keys past N into the forward's last 128-key tile.
# MICRO_BATCH is phase 8's: grad_accum's microbatch, on which it runs K1,
# K2, K4 and K5.
NPTS = MODEL_PARAMS["num_points"]
MICRO_BATCH = BATCH // TRAINER_OPTIONS["grad_accum"]
K1_CASES = ((BATCH, NPTS, 4, 64, torch.bfloat16), (1, NPTS, 4, 64, torch.bfloat16),
            (MICRO_BATCH, NPTS, 4, 64, torch.bfloat16),
            (BATCH, 192, 4, 64, torch.bfloat16), (4, NPTS, 4, 64, torch.float32))
# K4 and K5 at the main path's batch, then at phase 8's microbatch
CHAMFER_BATCHES = (BATCH, MICRO_BATCH)
K3_CASES = ((BATCH, NPTS, 2, 128, torch.bfloat16), (BATCH, NPTS, 1, 256, torch.bfloat16),
            (BATCH, NPTS, 3, 64, torch.bfloat16), (BATCH, 192, 2, 128, torch.bfloat16),
            (4, NPTS, 2, 128, torch.float32),
            # heads wider than 256 (d_model 320 or 512 with one head)
            (8, NPTS, 1, 320, torch.bfloat16), (8, NPTS, 1, 512, torch.bfloat16),
            (1, NPTS, 1, 512, torch.float32))
# fused FFN shapes (M, D, F, dtype): the main path's M = B * N rows at
# the shipped widths, wider models' widths, then a smaller M in f32
K6_CASES = ((BATCH * 2048, 256, 512, torch.bfloat16), (16 * 2048, 384, 1536, torch.bfloat16),
            (16 * 2048, 512, 2048, torch.bfloat16), (8192, 256, 512, torch.float32))
# Phase 4d: the JAX package's attention switches, each with the attention
# kernels it must launch on the shipped config's eval step and those it
# must not
ATTN_SWITCHES = (
    ({"VST_DISABLE_DENSE_ATTN": "1"}, (),
     ("dense_attn_fwd", "dense_attn_bhnd_fwd")),
    ({"VST_DENSE_ATTN_PACKED": "0"}, ("dense_attn_bhnd_fwd",), ("dense_attn_fwd",)),
    ({"VST_FUSED_QKV": "1"}, ("dense_attn_fwd",), ("dense_attn_bhnd_fwd",)),
)
CHAMFER_OFF_GATE_BATCH = 12


def _sync_ms(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds a call of fn() takes on the current stream: CUDA events
    around a run of `iters` calls back to back, after `warmup` calls; the
    median over 3 runs. In a run the host's launch path (Python, the
    wrapper's checks, the tensor maps) overlaps the device's work, as on
    the model's path; with one call between two events it would be timed
    too (scripts/ab_attn_fwd.py prints both)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return statistics.median(times)


def _device_ms(fn, calls: int = 10) -> float:
    """Device milliseconds a call of fn() takes, without the host's launch
    path: `calls` calls captured in one CUDA graph and replayed between
    two CUDA events (median of 3 replays), divided by `calls`. For the
    Chamfer kernels, whose calls are about as long as the host's launch
    path (scripts/ab_chamfer.py times both), back-to-back events time the
    host as much as the kernel; this is the kernels' share (and the
    graph's gaps between them). Not torch.profiler: with profiler
    sessions in phase 3, the train steps timed after it read several ms
    slower on some runs (scripts/ab_train_step.py)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return _sync_ms(graph.replay, 1, 1) / calls


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def _bound(flops: float, nbytes: float, dtype) -> dict:
    """{"bound_ms", "bound_by"} for `flops` operations of `dtype` and
    `nbytes` of device-memory traffic."""
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32
    t_ops, t_bytes = flops / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    if t_ops >= t_bytes:
        return {"bound_ms": t_ops, "bound_by": "operations"}
    return {"bound_ms": t_bytes, "bound_by": "bytes"}


def phase_environment():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return card


def phase_build():
    t0 = time.perf_counter()
    path = _kernels.build()
    _kernels.library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {path.name}")
    log = (_kernels.BUILD_DIR / "build.log")
    if log.exists():
        for line in log.read_text().splitlines():
            # register and spill counts, and ptxas's advisories (a wgmma
            # pipeline it had to serialise)
            if any(k in line for k in ("registers", "spill", "Compiling entry",
                                       "Performance", "injected")):
                print("  ptxas:", line.strip())


def _attn_inputs(b, n, h, d, dtype, gen, dev):
    # q, k scaled by 2 so the softmax is peaked, as in a trained model;
    # views of [B, N, H * D] tensors, as the model's projections give them
    mk = lambda s: (torch.randn(b, n, h * d, generator=gen, device=dev) * s).to(dtype)
    return [t.view(b, n, h, d) for t in (mk(2.0), mk(2.0), mk(1.0))]


def _sdpa_ms(q, k, v, do, scale):
    """The library yardstick: F.scaled_dot_product_attention on contiguous
    [B, H, N, D] copies of q, k, v. Returns (forward ms, backward ms: one
    autograd.grad call on a kept graph, forward + backward ms)."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    with torch.no_grad():
        fwd = _sync_ms(lambda: sdpa(qt, kt, vt, scale=scale), 10)
    o = sdpa(qt, kt, vt, scale=scale)
    bwd = _sync_ms(lambda: torch.autograd.grad(o, (qt, kt, vt), dot, retain_graph=True), 10)
    both = _sync_ms(lambda: torch.autograd.grad(sdpa(qt, kt, vt, scale=scale), (qt, kt, vt), dot),
                    10)
    return fwd, bwd, both


def check_attention(dev, gen, name, fwd, bwd, cases, f32_o_tol):
    """One attention route's forward (`fwd`, K1 or K3f) and backward
    (`bwd`, K2 or K3b) against their plain versions at each (B, N, H, D,
    dtype) of `cases`, O in f32 to `f32_o_tol`; returns the JSON fields
    of both for cases[0]."""
    res_f, res_b = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for i, (b, n, h, d, dtype) in enumerate(cases):
        scale = 1.0 / math.sqrt(d)
        q, k, v = _attn_inputs(b, n, h, d, dtype, gen, dev)
        do = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
        o, lse = fwd(q, k, v, scale)
        o2, lse2 = fwd(q, k, v, scale)
        got = bwd(q, k, v, o, lse, do, scale)
        again = bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        # no atomics: the same inputs give the same bits on every run
        repeat_f = torch.equal(o2, o) and torch.equal(lse2, lse)
        repeat = all(torch.equal(a, g_) for a, g_ in zip(again, got))
        o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, scale)
        want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
        err_o, err_l = _max_err(o, o_ref), _max_err(lse, lse_ref)
        if dtype == torch.bfloat16:
            tol_o = K1_BF16_O_TOL * max(1.0, float(o_ref.float().abs().max()))
            tol_l = K1_BF16_LSE_TOL * max(1.0, float(lse_ref.abs().max()))
            tol_b = K2_BF16_TOL
        else:
            tol_o = f32_o_tol * max(1.0, float(o_ref.abs().max()))
            tol_l = K1_F32_TOL * max(1.0, float(lse_ref.abs().max()))
            tol_b = K2_F32_TOL if d <= 256 else K3_F32_WIDE_TOL
        errs = [_max_err(g_, w_) for g_, w_ in zip(got, want)]
        bounds = [tol_b * float(w_.float().abs().max()) for w_ in want]
        ms_f = _sync_ms(lambda: fwd(q, k, v, scale), 10)
        ms_b = _sync_ms(lambda: bwd(q, k, v, o, lse, do, scale), 10)
        plain_f = _sync_ms(lambda: denseattn.dense_attention_fwd_plain(q, k, v, scale), 3, 1)
        plain_b = _sync_ms(
            lambda: denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale), 3, 1)
        lib_f, lib_b, lib_fb = _sdpa_ms(q, k, v, do, scale)
        es = q.element_size()
        rows = b * n * h * d
        bound_f = _bound(4.0 * b * h * n * n * d, 4 * es * rows + 4 * b * h * n, dtype)
        bound_b = _bound(10.0 * b * h * n * n * d, 8 * es * rows + 4 * b * h * n, dtype)
        tag = f"{name} B={b} N={n} H={h} D={d} {str(dtype)[6:]}"
        print(f"{tag} fwd: max|dO| {err_o:.3e} (bound {tol_o:.3e}) max|dLSE| {err_l:.3e} "
              f"(bound {tol_l:.3e}); repeat bitwise equal {repeat_f}; kernel {ms_f:.4f} ms "
              f"({4.0 * b * h * n * n * d / ms_f / 1e9:.1f} TFLOP/s), plain {plain_f:.4f} ms, "
              f"bound {bound_f['bound_ms']:.4f} ms ({bound_f['bound_by']}), "
              f"sdpa {lib_f:.4f} ms")
        print(f"{tag} bwd: max|d dq,dk,dv| "
              + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
              + f"; repeat bitwise equal {repeat}; kernel {ms_b:.4f} ms "
              f"({10.0 * b * h * n * n * d / ms_b / 1e9:.1f} TFLOP/s at 10 B H N^2 D, "
              f"{14.0 * b * h * n * n * d / ms_b / 1e9:.1f} at the 14 B H N^2 D executed), "
              f"plain {plain_b:.4f} ms, bound {bound_b['bound_ms']:.4f} ms "
              f"({bound_b['bound_by']}), sdpa backward {lib_b:.4f} ms, sdpa forward + "
              f"backward {lib_fb:.4f} ms (contiguous [B, H, N, D] copies)")
        if not (err_o <= tol_o and err_l <= tol_l):
            raise AssertionError(f"{name} forward disagrees with its plain version: {tag}")
        if not all(e <= t for e, t in zip(errs, bounds)):
            raise AssertionError(f"{name} backward disagrees with its plain version: {tag}")
        if not repeat_f:
            raise AssertionError(f"{name} forward differs from run to run: {tag}")
        if not repeat:
            raise AssertionError(f"{name} backward differs from run to run: {tag}")
        res_f["max_abs_err"] = max(res_f["max_abs_err"], err_o, err_l)
        res_b["max_abs_err"] = max(res_b["max_abs_err"], *errs)
        if i == 0:
            res_f.update(ms=ms_f, plain_ms=plain_f, library_ms=lib_f, **bound_f)
            res_b.update(ms=ms_b, plain_ms=plain_b, library_ms=lib_b, **bound_b)
    return res_f, res_b


def _chamfer_bytes(b, n, m):
    """Clouds read once (f32 xyz) and one f32 value and one int32 index a
    point written, both sides."""
    return b * (n + m) * (3 * 4 + 8)


def check_chamfer(dev, gen):
    """K4 at each batch of CHAMFER_BATCHES, bitwise against the plain
    version and from run to run, and timed; returns the JSON fields of
    the first."""
    n = MODEL_PARAMS["num_points"]
    res = None
    for b in CHAMFER_BATCHES:
        pred = torch.randn(b, n, 3, generator=gen, device=dev)
        gt = torch.randn(b, n, 3, generator=gen, device=dev)
        got = chamfer.chamfer_nn_packed(pred, gt)
        torch.cuda.synchronize()
        want = chamfer.chamfer_nn_packed_plain(pred, gt)
        err = max(_max_err(got[0], want[0]), _max_err(got[2], want[2]))
        same_idx = torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
        same_bits = all(torch.equal(a.view(torch.int32), w.view(torch.int32))
                        for a, w in ((got[0], want[0]), (got[2], want[2])))
        same_bits = same_bits and all(
            torch.equal(a, g_) for a, g_ in zip(chamfer.chamfer_nn_packed(pred, gt), got))
        ms = _sync_ms(lambda: chamfer.chamfer_nn_packed(pred, gt), 10)
        device_ms = _device_ms(lambda: chamfer.chamfer_nn_packed(pred, gt))
        plain_ms = _sync_ms(lambda: chamfer.chamfer_nn_packed_plain(pred, gt), 3, 1)
        # one d2 a pair (3 sub, 3 mul, 2 add) and a compare a pair each way
        bound = _bound(10.0 * b * n * n, _chamfer_bytes(b, n, n), torch.float32)
        print(f"chamfer_nn_packed B={b} N={n}: argmin equal {same_idx}, min bitwise "
              f"equal and run to run {same_bits}, max|dmin| {err:.3e} (bound {K4_TOL}); kernel "
              f"{ms:.4f} ms a call back to back (1 launch and the key row's fill), "
              f"{device_ms:.4f} ms of it on the device, plain {plain_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']})")
        if not (same_idx and same_bits and err <= K4_TOL):
            raise AssertionError(f"chamfer_nn_packed disagrees with its plain version (B={b})")
        if res is None:
            res = dict(max_abs_err=err, ms=ms, device_ms=device_ms, plain_ms=plain_ms,
                       library_ms=None, **bound)
    return res


def check_chamfer_bwd(dev, gen):
    """K5 at each batch of CHAMFER_BATCHES on random clouds (the first
    batch's row is the one the JSON line reports) and on skewed ones
    (half of gt on 4 pred points, long inverse lists), each bitwise
    against the plain version run on the CPU and from run to run, and
    timed; on random clouds also within K5_TOL of the plain version on
    the card."""
    n = MODEL_PARAMS["num_points"]
    res = None
    for b in CHAMFER_BATCHES:
        for inputs in ("random", "skewed"):
            pred = torch.randn(b, n, 3, generator=gen, device=dev)
            gt = torch.randn(b, n, 3, generator=gen, device=dev)
            if inputs == "skewed":
                gt[:, : n // 2] = pred[:, :4].repeat(1, n // 8, 1) + 1e-3
            _, argp, _, argg = chamfer.chamfer_nn_packed(pred, gt)
            got = chamfer.chamfer_bwd(pred, gt, argp, argg)
            torch.cuda.synchronize()
            want = chamfer.chamfer_bwd_plain(pred, gt, argp, argg)
            errs = [_max_err(g_, w_) for g_, w_ in zip(got, want)]
            bounds = [K5_TOL * float(w_.abs().max()) for w_ in want]
            cpu = chamfer.chamfer_bwd_plain(pred.cpu(), gt.cpu(), argp.cpu(), argg.cpu())
            same_cpu = all(torch.equal(g_.cpu(), c_) for g_, c_ in zip(got, cpu))
            again = chamfer.chamfer_bwd(pred, gt, argp, argg)
            repeat = all(torch.equal(a_, g_) for a_, g_ in zip(again, got))
            ms = _sync_ms(lambda: chamfer.chamfer_bwd(pred, gt, argp, argg), 10)
            device_ms = _device_ms(lambda: chamfer.chamfer_bwd(pred, gt, argp, argg))
            plain_ms = _sync_ms(lambda: chamfer.chamfer_bwd_plain(pred, gt, argp, argg), 3, 1)
            # a point a side: 3 sub and 3 mul for its own term, 3 adds scattered;
            # clouds and argmins read, both gradients written
            bound = _bound(9.0 * 2 * b * n, 2 * b * n * (12 + 4 + 12), torch.float32)
            longest = int(torch.bincount(argg[0].long()).max())
            print(f"chamfer_bwd B={b} N={n} {inputs} (longest inverse list {longest}): "
                  "max|d dpred, dgt| from the card's plain version "
                  + ", ".join(f"{e:.3e}" + ("" if inputs == "skewed" else f" (bound {t:.3e})")
                              for e, t in zip(errs, bounds))
                  + f", bitwise equal to the CPU plain version {same_cpu}, run to run "
                  f"{repeat}; kernel {ms:.4f} ms a call back to back, {device_ms:.4f} ms of it "
                  f"on the device, plain {plain_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
                  f"({bound['bound_by']})")
            # the card's plain version adds with atomics, in an order that changes
            # from run to run; a list of hundreds of terms can move it by more
            # than K5_TOL (the line above prints how far), so there the CPU
            # run, which adds in the kernel's order, decides alone
            near = inputs == "skewed" or all(e <= t for e, t in zip(errs, bounds))
            if not (near and same_cpu and repeat):
                raise AssertionError(
                    f"chamfer_bwd disagrees with its plain version ({inputs}, B={b})")
            if res is None:
                res = dict(max_abs_err=max(errs), ms=ms, device_ms=device_ms,
                           plain_ms=plain_ms, library_ms=None, **bound)
    return res


def _ffn_inputs(m, d, f, dtype, gen, dev):
    """x, dy, w1 [F, D], b1, w2 [D, F], b2 on the grid K6_*_TOL explains:
    every value a small integer times a power of two."""
    grid = lambda shape, sd, step: (
        torch.randn(shape, generator=gen, device=dev) * sd / step).round().clamp(-64, 64) * step
    x, dy = grid((m, d), 1.0, 1 / 8), grid((m, d), 1.0, 1 / 8)
    w1, w2 = grid((f, d), d ** -0.5, 1 / 256), grid((d, f), f ** -0.5, 1 / 256)
    b1, b2 = grid((f,), 0.05, 1 / 2048), grid((d,), 0.05, 1 / 2048)
    return [t.to(dtype) for t in (x, dy, w1, b1, w2, b2)]


def check_ffn(dev, gen):
    """The fused FFN forward (K6f) and backward (K6b) against their plain
    versions at each case of K6_CASES, with the unfused Dense -> ReLU ->
    Dense composition timed beside them as a reference (there is no one
    PyTorch call for the fused function: library_ms is null)."""
    res_f, res_b = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    for i, (m, d, f, dtype) in enumerate(K6_CASES):
        x, dy, w1, b1, w2, b2 = _ffn_inputs(m, d, f, dtype, gen, dev)
        y = ffn.fused_ffn_fwd(x, w1, b1, w2, b2)
        got = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
        torch.cuda.synchronize()
        y_ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
        want = ffn.fused_ffn_bwd_plain(x, dy, w1, b1, w2)
        tol = K6_BF16_TOL if dtype == torch.bfloat16 else K6_F32_TOL
        err_y, tol_y = _max_err(y, y_ref), tol * float(y_ref.float().abs().max())
        errs = [_max_err(g_, w_) for g_, w_ in zip(got, want)]
        bounds = [tol * float(w_.float().abs().max()) for w_ in want]
        ms_f = _sync_ms(lambda: ffn.fused_ffn_fwd(x, w1, b1, w2, b2), 10)
        ms_b = _sync_ms(lambda: ffn.fused_ffn_bwd(x, dy, w1, b1, w2), 10)
        plain_f = _sync_ms(lambda: ffn.fused_ffn_plain(x, w1, b1, w2, b2), 3, 1)
        plain_b = _sync_ms(lambda: ffn.fused_ffn_bwd_plain(x, dy, w1, b1, w2), 3, 1)
        # references, not yardsticks of the same function: the unfused
        # path's Dense semantics (product and bias add rounded apart), and
        # cuBLASLt's bias + ReLU epilogue on the first product
        leaves = [t.clone().requires_grad_() for t in (x, w1, b1, w2, b2)]
        unfused = lambda xx, a1, c1, a2, c2: xx + (torch.relu(xx @ a1.t() + c1) @ a2.t() + c2)
        epilogue = lambda xx, a1, c1, a2, c2: xx + torch.addmm(
            c2, torch._addmm_activation(c1, xx, a1.t()), a2.t())
        with torch.no_grad():
            ref_f = _sync_ms(lambda: unfused(*leaves), 10)
            epi_f = _sync_ms(lambda: epilogue(*leaves), 10)
        ref_fb = _sync_ms(lambda: torch.autograd.grad(unfused(*leaves), leaves, dy), 10)
        es = x.element_size()
        wbytes = es * (2 * d * f + f + d)
        bound_f = _bound(4.0 * m * d * f, es * 2 * m * d + wbytes, dtype)
        bound_b = _bound(10.0 * m * d * f, es * 3 * m * d + 2 * wbytes, dtype)
        tag = f"fused_ffn M={m} D={d} F={f} {str(dtype)[6:]}"
        print(f"{tag} fwd: max|dy| {err_y:.3e} (bound {tol_y:.3e}); kernel {ms_f:.4f} ms "
              f"({4.0 * m * d * f / ms_f / 1e9:.1f} TFLOP/s), plain {plain_f:.4f} ms, bound "
              f"{bound_f['bound_ms']:.4f} ms ({bound_f['bound_by']}); unfused Dense-ReLU-Dense "
              f"reference {ref_f:.4f} ms, cuBLASLt bias+ReLU epilogue reference {epi_f:.4f} ms")
        print(f"{tag} bwd: max|d dx,dw1,db1,dw2,db2| "
              + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
              + f"; kernel {ms_b:.4f} ms ({10.0 * m * d * f / ms_b / 1e9:.1f} TFLOP/s), plain "
              f"{plain_b:.4f} ms, bound {bound_b['bound_ms']:.4f} ms ({bound_b['bound_by']}); "
              f"unfused reference forward + backward {ref_fb:.4f} ms; K6f + K6b "
              f"{ms_f + ms_b:.4f} ms")
        if not err_y <= tol_y:
            raise AssertionError(f"fused_ffn forward disagrees with its plain version: {tag}")
        if not all(e <= t for e, t in zip(errs, bounds)):
            raise AssertionError(f"fused_ffn backward disagrees with its plain version: {tag}")
        if not torch.equal(ffn.fused_ffn_fwd(x, w1, b1, w2, b2), y):
            raise AssertionError(f"fused_ffn forward differs from run to run: {tag}")
        again = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
        if not all(torch.equal(a, g_) for a, g_ in zip(again, got)):
            raise AssertionError(f"fused_ffn backward differs from run to run: {tag}")
        print(f"{tag}: forward and backward repeat bitwise equal True")
        res_f["max_abs_err"] = max(res_f["max_abs_err"], err_y)
        res_b["max_abs_err"] = max(res_b["max_abs_err"], *errs)
        if i == 0:
            res_f.update(ms=ms_f, plain_ms=plain_f, library_ms=None, **bound_f)
            res_b.update(ms=ms_b, plain_ms=plain_b, library_ms=None, **bound_b)
    return res_f, res_b


# the launch counter of every kernel, by the name the JSON line gives it
COUNTERS = {
    "dense_attn_fwd": denseattn.dense_attention_fwd,
    "dense_attn_bwd": denseattn.dense_attention_bwd,
    "dense_attn_bhnd_fwd": denseattn.dense_attention_bhnd,
    "dense_attn_bhnd_bwd": denseattn.dense_attention_bwd_bhnd,
    "chamfer_nn_packed": chamfer.chamfer_nn_packed,
    "chamfer_bwd": chamfer.chamfer_bwd,
    "ffn_fwd": ffn.fused_ffn_fwd,
    "ffn_bwd": ffn.fused_ffn_bwd,
}


def _reset_launches():
    for fn in COUNTERS.values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in COUNTERS.items()}


def _expect_launches(launches, path, ran, idle=()):
    """Raise unless every kernel of `ran` launched and none of `idle` did."""
    print(f"{path} launches: {launches}")
    for name in ran:
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched on {path}")
    for name in idle:
        if launches[name]:
            raise AssertionError(f"kernel {name} ran on {path}: {launches}")


def phase_eval_generation(dev):
    gen = torch.Generator().manual_seed(SEED)
    model = build_model("setvae", "shapenet", MODEL_PARAMS,
                        beta=MODEL_PARAMS["beta_list"][0], generator=gen).to(dev)
    n, latent = MODEL_PARAMS["num_points"], MODEL_PARAMS["latent_channel"]
    x_all, _ = fake_point_clouds(BATCH * (EVAL_BATCHES + 1), n, seed=SEED)
    xs = torch.from_numpy(x_all).to(dev).view(EVAL_BATCHES + 1, BATCH, n, 3)
    eps = torch.randn(EVAL_BATCHES + 1, BATCH, latent, generator=gen).to(dev)
    eval_step = make_eval_step(model)
    torch.cuda.synchronize()

    _reset_launches()
    eval_step(xs[0], eps[0])                         # warm-up
    torch.cuda.synchronize()
    times, metrics = [], []
    for i in range(1, EVAL_BATCHES + 1):
        t0 = time.perf_counter()
        m = {k: float(v) for k, v in eval_step(xs[i], eps[i]).items()}
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append(m)
    generate_samples(model, BATCH, BATCH, seed=SEED)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = generate_samples(model, GEN_BATCHES * BATCH, BATCH, seed=SEED + 1)
    gen_s = time.perf_counter() - t0
    launches = _read_launches()

    for i, m in enumerate(metrics):
        print(f"eval batch {i}: " + " ".join(f"{k} {v:.6f}" for k, v in m.items()))
        if not all(math.isfinite(v) for v in m.values()):
            raise AssertionError(f"non-finite eval loss terms: {m}")
    print(f"eval step: {statistics.median(times):.3f} ms/batch median, "
          f"{statistics.mean(times):.3f} mean over {EVAL_BATCHES} batches of {BATCH} x {n} "
          f"(host clock, each batch ends in a device sync)")
    print(f"generation: {samples.shape} in {gen_s:.4f} s -> "
          f"{samples.shape[0] / gen_s:.1f} clouds/s")
    if samples.shape != (GEN_BATCHES * BATCH, n, 3) or not np.isfinite(samples).all():
        raise AssertionError(f"bad generated clouds: shape {samples.shape}")
    others = [k for k in COUNTERS if k not in ("dense_attn_fwd", "chamfer_nn_packed")]
    _expect_launches(launches, "eval and generation", ("dense_attn_fwd", "chamfer_nn_packed"),
                     others)


def _build(exp_type, params, seed=SEED):
    return build_model(exp_type, "shapenet", params, beta=params["beta_list"][0],
                       alpha=params.get("alpha_list", [0.01])[0],
                       generator=torch.Generator().manual_seed(seed))


def _clouds_and_noise(count, batch, params, dev, seed):
    n, latent = params["num_points"], params["latent_channel"]
    x_all, _ = fake_point_clouds(batch * count, n, seed=seed)
    xs = torch.from_numpy(x_all).to(dev).view(count, batch, n, 3)
    gen = torch.Generator().manual_seed(seed)
    return xs, torch.randn(count, batch, latent, generator=gen).to(dev)


def _time_train_step(exp_type, params, batch, dev, tag="bf16", n_micro=1, dropout=False,
                     steps=TIMED_STEPS):
    """Median ms/step of the train step (make_train_step, or with n_micro
    > 1 make_accum_train_step; with `dropout`, keep masks from a CUDA
    generator) over `steps` steps after two warm-up steps, host clock,
    each step ending in a scalar fetch."""
    model = _build(exp_type, params).to(dev)
    step = make_accum_train_step(model, make_optimizer(model.parameters(), lr=LR), n_micro)
    masks = torch.Generator(device=dev).manual_seed(SEED) if dropout else None
    xs, eps = _clouds_and_noise(steps + 2, batch, params, dev, SEED + 4)
    for i in range(2):
        float(step(xs[i], eps[i], 0.5, masks)["loss"])
    times, terms = [], []
    for i in range(2, steps + 2):
        t0 = time.perf_counter()
        terms.append({k: float(v) for k, v in step(xs[i], eps[i], 0.5, masks).items()})
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"{exp_type} train step ({tag}): non-finite loss terms {terms}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"train step {exp_type} B={batch} N={params['num_points']} {tag}: "
          f"{statistics.median(times):.3f} ms/step median, {statistics.mean(times):.3f} mean "
          f"over {steps} steps (host clock, each step ends in a scalar fetch); losses "
          f"{[round(t['loss'], 4) for t in terms]}; peak device memory so far {peak:.2f} GiB")
    return statistics.median(times)


def _time_eval_step(exp_type, params, batch, dev, tag="bf16"):
    """Median ms/batch of make_eval_step over EVAL_BATCHES batches after a
    warm-up, host clock, each batch ending in a scalar fetch."""
    model = _build(exp_type, params).to(dev)
    step = make_eval_step(model)
    xs, eps = _clouds_and_noise(EVAL_BATCHES + 1, batch, params, dev, SEED + 5)
    step(xs[0], eps[0])
    torch.cuda.synchronize()
    times, terms = [], []
    for i in range(1, EVAL_BATCHES + 1):
        t0 = time.perf_counter()
        terms.append({k: float(v) for k, v in step(xs[i], eps[i]).items()})
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"{exp_type} eval step ({tag}): non-finite loss terms {terms}")
    print(f"eval step {exp_type} B={batch} N={params['num_points']} {tag}: "
          f"{statistics.median(times):.3f} ms/batch median over {EVAL_BATCHES} batches "
          f"(host clock); loss {terms[-1]['loss']:.6f}")
    return statistics.median(times)


def _train_and_test(params, epochs, dev):
    """train_and_test on fake clouds at the shipped SetVAE config's common
    params into a temporary directory; checks its numbers and artifacts."""
    model = _build("setvae", params)
    dataset_params = dict(COMMON_PARAMS["dataset_params"], fake=True)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        state, summary = train_and_test(
            model, epochs=epochs, batch_size=BATCH, dataset_name=COMMON_PARAMS["exp_data"],
            logfilename=COMMON_PARAMS["logfilename"], resultname=COMMON_PARAMS["resultname"],
            grad_clip=COMMON_PARAMS["grad_clip"], seed=SEED, dataset_params=dataset_params,
            output_root=root, lr=LR, device=dev,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        params_dir = os.path.join(summary["result_dir"], "params")
        clouds_dir = os.path.join(summary["result_dir"], "point_clouds")
        written = (sorted(os.listdir(params_dir)), len(os.listdir(clouds_dir)),
                   sorted(os.listdir(os.path.join(root, "log"))))
    numbers = dict(summary["eval"], **summary["posterior_metrics"])
    print(f"train_and_test: {epochs} epochs of {state.step // epochs} steps at "
          f"B={BATCH} in {wall:.2f} s; final eval {summary['eval']}; posterior metrics "
          f"{summary['posterior_metrics']}; wrote params {written[0]}, {written[1]} point-cloud "
          f"files, log {written[2]}")
    if not all(math.isfinite(v) for v in numbers.values()):
        raise AssertionError(f"non-finite train/eval numbers: {numbers}")
    if written[0] != [f"model_{epochs - 1}.pkl"] or written[1] != 24 or not written[2]:
        raise AssertionError(f"train_and_test did not write its artifacts: {written}")


PACKED_PATH = ("dense_attn_fwd", "dense_attn_bwd", "chamfer_nn_packed", "chamfer_bwd")


def phase_train(dev):
    """The main path: train_and_test, then the train step's ms/step."""
    _reset_launches()
    _train_and_test(MODEL_PARAMS, TRAIN_EPOCHS, dev)
    launches = _read_launches()
    _expect_launches(launches, "the training path", PACKED_PATH,
                     [k for k in COUNTERS if k not in PACKED_PATH])
    _time_train_step("setvae", MODEL_PARAMS, BATCH, dev)
    _time_train_step("setlrvae", dict(MODEL_PARAMS, **SETLRVAE_PARAMS), SETLRVAE_BATCH, dev)
    return launches


def phase_heads2(dev):
    """SetVAE with num_heads 2 (128-wide heads): the BHND route."""
    params = dict(MODEL_PARAMS, **HEADS2_OVERRIDE)
    tag = f"bf16 num_heads {params['num_heads']}"
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    _expect_launches(launches, "the num_heads 2 path",
                     ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd", "chamfer_nn_packed",
                      "chamfer_bwd"),
                     ("dense_attn_fwd", "dense_attn_bwd", "ffn_fwd", "ffn_bwd"))
    return launches


def phase_fused_ffn(dev):
    """The shipped SetVAE and SetLRVAE configs with VST_FUSED_FFN=1."""
    tag = "bf16 " + " ".join(f"{k}={v}" for k, v in FUSED_FFN_ENV.items())
    lr_params = dict(MODEL_PARAMS, **SETLRVAE_PARAMS)
    with mock.patch.dict(os.environ, FUSED_FFN_ENV):
        _reset_launches()
        _time_train_step("setvae", MODEL_PARAMS, BATCH, dev, tag)
        _time_eval_step("setvae", MODEL_PARAMS, BATCH, dev, tag)
        _time_train_step("setlrvae", lr_params, SETLRVAE_BATCH, dev, tag)
        _time_eval_step("setlrvae", lr_params, SETLRVAE_BATCH, dev, tag)
        launches = _read_launches()
    _expect_launches(launches, "the VST_FUSED_FFN=1 path", PACKED_PATH + ("ffn_fwd", "ffn_bwd"),
                     ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd"))
    return launches


def phase_routes(dev):
    """The shipped SetVAE eval step under each attention switch, then a
    Chamfer call outside the packed kernel's gate; returns the launches."""
    model = _build("setvae", MODEL_PARAMS).to(dev)
    step = make_eval_step(model)
    xs, eps = _clouds_and_noise(1, BATCH, MODEL_PARAMS, dev, SEED + 6)
    _reset_launches()
    base = {k: float(v) for k, v in step(xs[0], eps[0]).items()}
    for env, ran, idle in ATTN_SWITCHES:
        tag = " ".join(f"{k}={v}" for k, v in env.items())
        with mock.patch.dict(os.environ, env):
            _reset_launches()
            terms = {k: float(v) for k, v in step(xs[0], eps[0]).items()}
            launches = _read_launches()
        rel = max(abs(terms[k] - base[k]) / max(abs(base[k]), 1e-12)
                  for k in ("loss", "recon", "reg"))
        print(f"eval step under {tag}: loss terms {terms}, max rel diff from the default route "
              f"{rel:.3e} (bound {REF_BF16_LOSS_RTOL})")
        _expect_launches(launches, f"the eval step under {tag}", ran + ("chamfer_nn_packed",),
                         idle)
        if not (all(math.isfinite(v) for v in terms.values()) and rel <= REF_BF16_LOSS_RTOL):
            raise AssertionError(f"eval step under {tag} disagrees with the default route")
    gen = torch.Generator(device=dev).manual_seed(SEED + 7)
    b, n = CHAMFER_OFF_GATE_BATCH, MODEL_PARAMS["num_points"]
    pred = torch.randn(b, n, 3, generator=gen, device=dev)
    gt = torch.randn(b, n, 3, generator=gen, device=dev)
    _reset_launches()
    val = chamfer.best_chamfer(pred, gt)
    launches = _read_launches()
    exact = chamfer.chamfer_distance(pred, gt)
    print(f"best_chamfer B={b} N={n}: {float(val):.8f}, exact tiled {float(exact):.8f}, "
          f"equal {torch.equal(val, exact)}")
    _expect_launches(launches, f"best_chamfer at B={b}", (), tuple(COUNTERS))
    if not torch.equal(val, exact):
        raise AssertionError(f"best_chamfer at B={b} is not the exact tiled value")


class _MaskTape:
    """Keep masks for dropout: drawn on the host from a seeded generator
    and recorded on the first run, handed out again in the same order on
    the second, so the card and the CPU drop the same elements."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)
        self.masks, self.next = [], None

    def __call__(self, shape, keep_prob):
        if self.next is None:
            self.masks.append(torch.rand(shape, generator=self.gen) < keep_prob)
            return self.masks[-1]
        self.next += 1
        return self.masks[self.next - 1]

    def replay(self):
        self.next = 0
        return self


def _train_step_once(where, exp_type, params, x, eps, masks=None):
    """One train step at lr LR from the seeded weights: (loss terms,
    gradients, parameters after the update, buffers after it), on the
    host."""
    model = _build(exp_type, params).to(where)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    terms = {k: float(v) for k, v in step(torch.from_numpy(x).to(where),
                                          torch.from_numpy(eps).to(where), 0.5, masks).items()}
    grads = {k: None if p.grad is None else p.grad.float().cpu()
             for k, p in model.named_parameters()}
    after = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
    buffers = {k: b.float().cpu() for k, b in model.named_buffers()}
    return terms, grads, after, buffers


def _compare_train_step(dev, tag, x, eps, params, loss_rtol, grad_rtol, moved_share,
                        exp_type="setvae", masks=None):
    """One train step on the CPU and on the card from the same weights,
    clouds, noise and (with `masks`, a _MaskTape) keep masks."""
    t_cpu, g_cpu, p_cpu, b_cpu = _train_step_once("cpu", exp_type, params, x, eps, masks)
    t_dev, g_dev, p_dev, b_dev = _train_step_once(dev, exp_type, params, x, eps,
                                                  masks and masks.replay())
    initial = _build(exp_type, params).state_dict()
    rel = max(abs(t_dev[k] - t_cpu[k]) / max(abs(t_cpu[k]), 1e-12)
              for k in ("loss", "recon", "reg", "raw_kl"))
    if {k for k, g in g_cpu.items() if g is None} != {k for k, g in g_dev.items() if g is None}:
        raise AssertionError(f"train step {tag}: card and CPU give gradients to other parameters")
    # a key projection's bias has an analytically zero gradient (the
    # softmax is shift-invariant along each row), as have the DeepSets
    # hidden Dense biases (a BatchNorm follows each): what is computed is
    # roundoff on either side, which Adam's first update turns into +-lr,
    # so they are left out of the comparisons
    skip = pre_batchnorm_biases(g_cpu)
    keys = [k for k, g in g_cpu.items()
            if g is not None and not k.endswith("key.bias") and k not in skip]
    diff = math.sqrt(sum(float(((g_dev[k] - g_cpu[k]) ** 2).sum()) for k in keys))
    norm = math.sqrt(sum(float((g_cpu[k] ** 2).sum()) for k in keys))
    grad_rel = diff / norm
    # Adam's first update is about lr * sign(g) per element, so an element
    # whose small gradient has another sign on the card moves the other
    # way: bound the share of elements that moved apart by more than lr/10
    deltas = torch.cat([(p_dev[k] - p_cpu[k]).abs().reshape(-1) for k in keys])
    share = float((deltas > LR / 10).float().mean())
    frozen = [k for k, g in g_dev.items() if g is None]
    unchanged = all(torch.equal(p_dev[k], initial[k].float()) for k in frozen)
    # the cross-attention's query/key get no gradient unless dropout sends
    # it through the materialised scores; the DeepSets models have none
    want_frozen = masks is None and params.get("use_attention", True)
    stats = max((float((b_dev[k] - b_cpu[k]).abs().max()) / max(1.0, float(b_cpu[k].abs().max()))
                 for k in b_cpu), default=0.0)
    print(f"reference train step {tag}: loss terms max rel diff {rel:.3e} (bound {loss_rtol}); "
          f"gradient rel L2 diff {grad_rel:.3e} (bound {grad_rtol}) over {len(keys)} tensors; "
          f"updated params: share moved apart by > lr/10 {share:.3e} (bound {moved_share}), "
          f"max|d| {float(deltas.max()):.3e} (not bounded); {len(frozen)} parameters without a "
          f"gradient unchanged: {unchanged}; BatchNorm running statistics over {len(b_cpu)} "
          f"buffers max rel diff {stats:.3e} (bound {REF_BN_TOL}); cpu {t_cpu} card {t_dev}")
    if not (rel <= loss_rtol and grad_rel <= grad_rtol and share <= moved_share
            and unchanged and bool(frozen) == want_frozen and stats <= REF_BN_TOL):
        raise AssertionError(f"card and CPU train steps disagree ({tag})")


def _reference(dev, name, params):
    """Card (kernels) vs CPU (plain versions) on the same weights, 2
    clouds, f32 and bf16."""
    n, latent = params["num_points"], params["latent_channel"]
    x, _ = fake_point_clouds(2, n, seed=SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    eps = rng.standard_normal((2, latent)).astype(np.float32)
    z = rng.standard_normal((2, latent)).astype(np.float32)
    for mixed, loss_rtol, recon_atol in ((False, REF_F32_LOSS_RTOL, REF_F32_RECON_ATOL),
                                         (True, REF_BF16_LOSS_RTOL, REF_BF16_RECON_ATOL)):
        mp = dict(params, mixed_precision=mixed)
        outs = {}
        for where in ("cpu", dev):
            model = _build("setvae", mp).to(where)
            step = make_eval_step(model)
            _, decode, forward = make_apply_fns(model)
            xt, et = torch.from_numpy(x).to(where), torch.from_numpy(eps).to(where)
            outs[str(where)] = (
                {k: float(v) for k, v in step(xt, et).items()},
                forward(xt, et)[0].float().cpu(),
                decode(torch.from_numpy(z).to(where)).float().cpu(),
            )
        (m_cpu, r_cpu, g_cpu), (m_dev, r_dev, g_dev) = outs["cpu"], outs[str(dev)]
        rel = max(abs(m_dev[k] - m_cpu[k]) / max(abs(m_cpu[k]), 1e-12)
                  for k in ("loss", "recon", "reg"))
        err_r, err_g = _max_err(r_dev, r_cpu), _max_err(g_dev, g_cpu)
        tag = f"{name} {'bf16' if mixed else 'f32'}"
        print(f"reference {tag}: loss terms max rel diff {rel:.3e} (bound {loss_rtol}), "
              f"recon max|d| {err_r:.3e}, decode max|d| {err_g:.3e} (bound {recon_atol}); "
              f"cpu {m_cpu} card {m_dev}")
        if not (rel <= loss_rtol and err_r <= recon_atol and err_g <= recon_atol):
            raise AssertionError(f"card and CPU disagree ({tag})")
        grad_rtol, moved_share = ((REF_F32_GRAD_RTOL, REF_F32_MOVED_SHARE) if not mixed
                                  else (REF_BF16_GRAD_RTOL, REF_BF16_MOVED_SHARE))
        _compare_train_step(dev, tag, x, eps, mp, loss_rtol, grad_rtol, moved_share)


def phase_reference(dev):
    """The reference check for the shipped SetVAE config and for both
    configurations of phase 4c."""
    _reference(dev, "shipped", MODEL_PARAMS)
    _reference(dev, "num_heads 2", dict(MODEL_PARAMS, **HEADS2_OVERRIDE))
    with mock.patch.dict(os.environ, FUSED_FFN_ENV):
        launches = ffn.fused_ffn_fwd.launches
        _reference(dev, "VST_FUSED_FFN=1", MODEL_PARAMS)
        if ffn.fused_ffn_fwd.launches == launches:
            raise AssertionError("the VST_FUSED_FFN=1 reference did not run the fused FFN")


CHAMFER_PATH = ("chamfer_nn_packed", "chamfer_bwd")


def _others(ran):
    """Every kernel but those of `ran`."""
    return tuple(k for k in COUNTERS if k not in ran)


def phase_deepsets(dev):
    """The DeepSets SetVAE at the shipped widths: train step, eval step,
    generation; then card against CPU for SetVAE and SetLRVAE."""
    params = dict(MODEL_PARAMS, **DEEPSETS_OVERRIDE)
    tag = "f32 DeepSets"
    _reset_launches()
    _time_train_step("setvae", params, BATCH, dev, tag)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    model = _build("setvae", params).to(dev)
    generate_samples(model, BATCH, BATCH, seed=SEED)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    samples = generate_samples(model, GEN_BATCHES * BATCH, BATCH, seed=SEED + 1)
    gen_s = time.perf_counter() - t0
    launches = _read_launches()
    print(f"generation {tag}: {samples.shape} in {gen_s:.4f} s -> "
          f"{samples.shape[0] / gen_s:.1f} clouds/s")
    if samples.shape != (GEN_BATCHES * BATCH, params["num_points"], 3) or not np.isfinite(
            samples).all():
        raise AssertionError(f"bad generated clouds: shape {samples.shape}")
    _expect_launches(launches, "the DeepSets path", CHAMFER_PATH, _others(CHAMFER_PATH))
    n, latent = params["num_points"], params["latent_channel"]
    x, _ = fake_point_clouds(REF_CLOUDS, n, seed=SEED + 2)
    eps = np.random.default_rng(SEED + 3).standard_normal((REF_CLOUDS, latent)).astype(np.float32)
    for exp_type, mp in (("setvae", params), ("setlrvae", dict(params, **SETLRVAE_PARAMS))):
        _compare_train_step(dev, f"DeepSets {exp_type} f32", x, eps, mp, REF_F32_LOSS_RTOL,
                            REF_F32_GRAD_RTOL, REF_F32_MOVED_SHARE, exp_type)
    return launches


def phase_dropout(dev):
    """The shipped SetVAE with attn_dropout 0.1: train steps (no attention
    kernel), peak memory, the eval step (K1); card against CPU with the
    same masks at a reduced size."""
    params = dict(MODEL_PARAMS, **DROPOUT_OVERRIDE)
    train = None
    for batch in DROPOUT_BATCHES:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        try:
            _time_train_step("setvae", params, batch, dev, "bf16 attn_dropout 0.1", dropout=True,
                             steps=DROPOUT_STEPS)
        except torch.cuda.OutOfMemoryError as e:
            print(f"dropout train step at B={batch} does not fit the card: {str(e)[:200]}")
            continue
        train = _read_launches()
        print(f"dropout train step B={batch}: peak device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
              f"(torch.cuda.max_memory_allocated)")
        break
    if train is None:
        raise AssertionError(f"the dropout train step fits at none of B = {DROPOUT_BATCHES}")
    _expect_launches(train, "dropout training", CHAMFER_PATH, _others(CHAMFER_PATH))
    _reset_launches()
    _time_eval_step("setvae", params, BATCH, dev, "bf16 attn_dropout 0.1")
    evaluation = _read_launches()
    ran = ("dense_attn_fwd", "chamfer_nn_packed")
    _expect_launches(evaluation, "eval with attn_dropout 0.1", ran, _others(ran))
    ref = dict(params, num_points=DROPOUT_REF_POINTS)
    x, _ = fake_point_clouds(REF_CLOUDS, DROPOUT_REF_POINTS, seed=SEED + 2)
    eps = np.random.default_rng(SEED + 3).standard_normal(
        (REF_CLOUDS, ref["latent_channel"])).astype(np.float32)
    for mixed, bounds in ((False, (REF_F32_LOSS_RTOL, REF_F32_GRAD_RTOL, REF_F32_MOVED_SHARE)),
                          (True, (REF_BF16_LOSS_RTOL, REF_BF16_GRAD_RTOL, REF_BF16_MOVED_SHARE))):
        _compare_train_step(dev, f"attn_dropout 0.1 N={DROPOUT_REF_POINTS} "
                            f"{'bf16' if mixed else 'f32'}", x, eps,
                            dict(ref, mixed_precision=mixed), *bounds,
                            masks=_MaskTape(SEED + 8))
    return train, evaluation


def _same_state(a, b) -> bool:
    """Parameters, statistics, Adam's moments, count and step bit for bit."""
    same = all(torch.equal(v, w) for v, w in zip(a.model.state_dict().values(),
                                                 b.model.state_dict().values()))
    for name in ("mu", "nu"):
        same = same and all(torch.equal(v, w) for v, w in zip(
            adam_state(a)[name].values(), adam_state(b)[name].values()))
    return same and (a.optimizer.count, a.step) == (b.optimizer.count, b.step)


def phase_trainer_options(dev):
    """train_and_test with checkpoint_every, async_checkpoint and
    grad_accum at full width, then a resumed run that must end where the
    continuous one did; the grad_accum 2 train step's ms/step."""
    kw = dict(epochs=TRAIN_EPOCHS, batch_size=BATCH, dataset_name=COMMON_PARAMS["exp_data"],
              grad_clip=COMMON_PARAMS["grad_clip"], seed=SEED, lr=LR, device=dev,
              dataset_params=dict(COMMON_PARAMS["dataset_params"], fake=True))
    with tempfile.TemporaryDirectory() as root:
        _reset_launches()
        t0 = time.perf_counter()
        cont, summary = train_and_test(_build("setvae", MODEL_PARAMS),
                                       output_root=os.path.join(root, "a"), **TRAINER_OPTIONS,
                                       **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        params_dir = os.path.join(summary["result_dir"], "params")
        written = sorted(os.listdir(params_dir))
        resumed, _ = train_and_test(_build("setvae", MODEL_PARAMS, seed=SEED + 1),
                                    output_root=os.path.join(root, "b"),
                                    resume_from=os.path.join(params_dir, "ckpt_0.pkl"),
                                    grad_accum=TRAINER_OPTIONS["grad_accum"], **kw)
        same = _same_state(cont, resumed)
    print(f"train_and_test {TRAINER_OPTIONS}: {TRAIN_EPOCHS} epochs of "
          f"{cont.step // TRAIN_EPOCHS} steps at B={BATCH} in {wall:.2f} s; wrote {written}; "
          f"final eval {summary['eval']}; resumed from ckpt_0.pkl: step {resumed.step}, final "
          f"parameters, statistics and Adam state bitwise equal to the continuous run's {same}")
    if written != [f"ckpt_{e}.pkl" for e in range(TRAIN_EPOCHS)] + [
            f"model_{TRAIN_EPOCHS - 1}.pkl"]:
        raise AssertionError(f"train_and_test did not write its checkpoints: {written}")
    if not (same and all(math.isfinite(v) for v in summary["eval"].values())):
        raise AssertionError("the resumed run does not end where the continuous run did")
    _expect_launches(launches, "train_and_test with grad_accum 2", PACKED_PATH,
                     _others(PACKED_PATH))
    _time_train_step("setvae", MODEL_PARAMS, BATCH, dev,
                     f"bf16 grad_accum {TRAINER_OPTIONS['grad_accum']}",
                     n_micro=TRAINER_OPTIONS["grad_accum"])
    return launches


# Phase 9: the FlexibleVAE family. A literal copy of
# configs/config_pinwheel.yaml (tests/test_torch_isolation.py holds it to
# the file): LR-VAE on the pinwheel points, twelve blocks of 16, B = 1024,
# two sweep points. Its 1000 epochs are cut to PINWHEEL_EPOCHS.
PINWHEEL_CONFIG = {
    "experiment_type": "lrvae",
    "common_params": {
        "exp_data": "pinwheel",
        "exp_epochs": 1000,
        "batch_size": 1024,
        "niter": 1,
        "logfilename": None,
        "resultname": None,
        "grad_clip": {"enabled": True, "clip_type": "norm", "max_norm": 1.0,
                      "norm_type": 2.0, "clip_value": 1.0},
    },
    "model_params": {
        "beta_list": [0.001, 0.01],
        "log_mse": False,
        "encoder_type": "mlp",
        "decoder_type": "mlp",
        "fixed_var": False,
        "residual_connection": False,
        "hchans": [16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        "num_mc_samples": 1,
        "alpha_list": [0.0001],
        "pwise_reg": False,
    },
}
PINWHEEL_EPOCHS = 3
# configs/config_mnist.yaml's model_params and batch (held to the file by
# the same test): the MLP LR-VAE, ten blocks of 16, L = 4, B = 256. The
# MNIST readers are not ported (ROADMAP.md Queue 1 item 10b): the step
# runs on seeded [0, 1) images of MNIST's shape.
MNIST_PARAMS = {
    "beta_list": [0.001],
    "log_mse": False,
    "encoder_type": "mlp",
    "decoder_type": "mlp",
    "fixed_var": False,
    "residual_connection": False,
    "hchans": [16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
    "num_mc_samples": 4,
    "alpha_list": [0.1],
    "pwise_reg": False,
}
MNIST_BATCH = 256
# The JAX benchmark's model (bench.py:72): VanillaVAE.for_dataset("mnist",
# encoder_type="conv", decoder_type="mlp", beta=1.0), f32, B = 256.
CONV_VAE_PARAMS = {"encoder_type": "conv", "decoder_type": "mlp"}
CONV_VAE_BATCH = 256
FLEX_PROFILED = 5
# Card against CPU, the same weights and inputs, one train step: f32 on
# both, and float64 on both. The gradient is piecewise smooth: each
# LeakyReLU input picks one of two slopes, and some lie within f32
# roundoff of zero, so f32 and float64 runs can compute on different
# pieces. At the pinwheel config's state 14 of 794624 do, in the LR-VAE's
# second encoder pass, and there the decoder's gradient differs by 0.56
# relative L2 (the CPU's f32 step 0.37 from float64 over every leaf; on
# the f32 run's pieces float64 lands 1.7e-4 from it;
# tests/test_torch_flexible_config.py); the conv VAE's f32 step, 425
# inputs of 24293376 on the other side, is 3.3e-3 from float64, and
# 2.4e-5 on its own pieces (CPU). So the card's f32 step is held to the
# CPU's float64 step computed on the card's pieces (every LeakyReLU's
# slope taken from the card's run). Bounds:
#  - f32 loss terms, card against CPU: FLEX_REF_LOSS_RTOL relative;
#    statistics REF_BN_TOL;
#  - the float64 steps' gradients, card against CPU: FLEX_F64_GRAD_RTOL
#    relative L2 over every leaf (the same function in another summation
#    order);
#  - the card's f32 gradient against the CPU's float64 one on its pieces,
#    relative L2 over every leaf but the pre-BatchNorm biases (phase 6
#    leaves them out too): FLEX_F32_GRAD_RTOL for the pinwheel LR-VAE (CPU
#    1.7e-4; H100 9.3e-5), FLEX_CONV_F32_GRAD_RTOL for the conv VAE (CPU
#    and H100 2.4e-5); and REF_F32_MOVED_SHARE of the parameter elements
#    moved apart by more than lr/10 by Adam's first update.
# The conv VAE's step also runs once with the port's TF32 override off,
# under PyTorch's default cuDNN setting, and must then fail its bound
# (H100: 6.7e-4), or the bound could not tell TF32 from f32.
FLEX_REF_LOSS_RTOL = 1e-4
ADAM_F32_SQUARE_LIMIT = math.sqrt(torch.finfo(torch.float32).max)   # 1.84e19
FLEX_F64_GRAD_RTOL = 1e-8
FLEX_F32_GRAD_RTOL = 1e-3
FLEX_CONV_F32_GRAD_RTOL = 2e-4


def _busy_us(prof) -> float:
    """Microseconds the card was busy in a torch.profiler session: the
    union of its kernel intervals (the GPU ranges of user annotations,
    which enclose kernels, left out)."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and not e.is_user_annotation)
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def _flex_inputs(dataset, batch, count, seed):
    """`count` batches: the pinwheel config's seeded training points, or
    seeded [0, 1) images of MNIST's shape (NHWC)."""
    if dataset == "pinwheel":
        x = load_dataset("pinwheel", seed=seed)[0].X[:batch * count]
    else:
        x = np.random.default_rng(seed).random((batch * count, 28, 28, 1), dtype=np.float32)
    return x.reshape(count, batch, *x.shape[1:])


def _flex_build(kind, dataset, params, beta, alpha, il=0.0):
    return build_model(kind, dataset, params, beta=beta, alpha=alpha, il=il,
                       generator=torch.Generator().manual_seed(SEED))


def _flex_time(tag, kind, dataset, params, beta, alpha, batch, n_samples, dev, evaluate=False,
               il=0.0):
    """The train step's median ms/step over TIMED_STEPS steps after two
    warm-ups (host clock, each step ending in a scalar fetch), with
    `evaluate` the eval step's ms/batch too; the batches cycle through the
    9 batches of the pinwheel config (10000 points). No profiler session
    may have opened before (they slow later steps: scripts/ab_train_step.py).
    Returns a function that profiles FLEX_PROFILED more steps and prints the
    device's idle share, 1 - busy / the median."""
    model = _flex_build(kind, dataset, params, beta, alpha, il).to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    count = 9
    xs = torch.from_numpy(_flex_inputs(dataset, batch, count, SEED + 6)).to(dev)
    eps = torch.randn(count, n_samples, batch, model.latent_channel,
                      generator=torch.Generator().manual_seed(SEED + 7)).to(dev)
    for i in range(2):
        float(step(xs[i], eps[i], 0.5)["loss"])
    times, terms = [], []
    for i in range(2, 2 + TIMED_STEPS):
        t0 = time.perf_counter()
        terms.append({k: float(v) for k, v in step(xs[i % count], eps[i % count], 0.5).items()})
        times.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(times)
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"{tag} train step: non-finite loss terms {terms}")
    print(f"train step {tag} B={batch} L={n_samples}: {ms:.3f} ms/step median, "
          f"{statistics.mean(times):.3f} mean over {TIMED_STEPS} steps (host clock, each step ends "
          f"in a scalar fetch); losses {[round(t['loss'], 4) for t in terms]}")
    if evaluate:
        eval_step = make_eval_step(model)
        eval_eps = eps[:, :1]
        eval_step(xs[0], eval_eps[0], 0.5)
        torch.cuda.synchronize()
        ev = []
        for i in range(1, EVAL_BATCHES + 1):
            t0 = time.perf_counter()
            m = {k: float(v) for k, v in eval_step(xs[i], eval_eps[i], 0.5).items()}
            ev.append((time.perf_counter() - t0) * 1e3)
            if not all(math.isfinite(v) for v in m.values()):
                raise AssertionError(f"{tag} eval step: non-finite loss terms {m}")
        print(f"eval step {tag} B={batch}: {statistics.median(ev):.3f} ms/batch median over "
              f"{EVAL_BATCHES} batches (host clock, scalar fetch); loss {m['loss']:.6f}")

    def profile():
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(FLEX_PROFILED):
                float(step(xs[i % count], eps[i % count], 0.5)["loss"])
            torch.cuda.synchronize()
        kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
                      and not e.is_user_annotation) / FLEX_PROFILED
        busy = _busy_us(prof) / 1e3 / FLEX_PROFILED
        print(f"train step {tag}: device busy {busy:.3f} ms/step in {kernels:.0f} kernels "
              f"(torch.profiler, {FLEX_PROFILED} steps), idle {100 * (1 - busy / ms):.1f}% of the "
              f"unprofiled step ({ms:.3f} ms)")

    return profile


@contextlib.contextmanager
def _lrelu_pieces(signs, force=False):
    """Within it every LeakyReLU (torch.nn.functional.leaky_relu) appends
    the sign pattern of its input (x > 0, on the CPU) to `signs`; with
    `force` it takes its slopes from the next pattern of `signs` instead,
    so that a second run of the same step computes on the first run's
    pieces."""
    leaky, patterns = torch.nn.functional.leaky_relu, iter(signs)

    def piecewise(x, slope=0.01, inplace=False):
        if force:
            return torch.where(next(patterns).to(x.device), x, x * slope)
        signs.append((x > 0).cpu())
        return leaky(x, slope)

    with mock.patch.object(torch.nn.functional, "leaky_relu", piecewise):
        yield


def _flex_train_once(where, kind, dataset, params, beta, alpha, x, eps, dtype=torch.float32,
                     il=0.0):
    """One train step at lr LR from the seeded weights (in `dtype`: float64
    makes every layer compute in float64): (loss terms, gradients,
    parameters after, buffers after), on the host in float64."""
    model = _flex_build(kind, dataset, params, beta, alpha, il).to(where, dtype)
    for m in model.modules():
        if getattr(m, "dtype", None) == torch.float32:
            m.dtype = dtype
    terms = make_train_step(model, make_optimizer(model.parameters(), lr=LR))(
        torch.from_numpy(x).to(where, dtype), torch.from_numpy(eps).to(where, dtype), 0.5)
    # a parameter the loss does not reach has no gradient: zero (the ICNN
    # biases after its first layer, whose gradient through a Brenier map is
    # zero, when the LeakyReLU pieces are forced)
    return ({k: float(v) for k, v in terms.items()},
            {k: (p.grad if p.grad is not None else torch.zeros_like(p)).double().cpu()
             for k, p in model.named_parameters()},
            {k: p.detach().double().cpu() for k, p in model.named_parameters()},
            {k: b.double().cpu() for k, b in model.named_buffers()})


def _flex_compare(dev, tag, kind, dataset, params, beta, alpha, batch, n_samples, f32_rtol,
                  tf32_probe=False, il=0.0):
    """One train step on the CPU and on the card, the same weights, inputs
    and noise, in f32 and in float64, under the bounds above (`f32_rtol`
    on the card's f32 gradient). With `tf32_probe`, the card's f32 step
    once more with the port's TF32 override off (cuDNN's TF32 on), which
    must exceed `f32_rtol`."""
    x = _flex_inputs(dataset, batch, 1, SEED + 8)[0]
    latent = _flex_build(kind, dataset, params, beta, alpha, il).latent_channel
    eps = np.random.default_rng(SEED + 9).standard_normal(
        (n_samples, batch, latent)).astype(np.float32)
    run = lambda where, dtype=torch.float32: _flex_train_once(
        where, kind, dataset, params, beta, alpha, x, eps, dtype, il)

    def on_pieces(step):
        """`step`'s result, and the CPU's float64 step on its pieces."""
        signs = []
        with _lrelu_pieces(signs):
            out = step()
        with _lrelu_pieces(signs, force=True):
            return out, run("cpu", torch.float64), signs

    (t_dev, g_dev, p_dev, b_dev), (_, g_ref, p_ref, _), card_signs = on_pieces(lambda: run(dev))
    signs_64 = []
    with _lrelu_pieces(signs_64):
        _, g_64, _, _ = run("cpu", torch.float64)
    t_cpu, g_cpu, _, b_cpu = run("cpu")
    _, g_dev64, _, _ = run(dev, torch.float64)
    live = [k for k in g_64 if k not in pre_batchnorm_biases(g_64)]
    gap = lambda g, w, keys: math.sqrt(sum(float(((g[k] - w[k]) ** 2).sum()) for k in keys)
                                       / sum(float((w[k] ** 2).sum()) for k in keys))
    # an f32 gradient element above sqrt(f32 max) squares to inf in Adam's
    # second moment (optax's and the port's alike), which leaves that
    # element where it was; float64 moves it by lr. Those elements (an
    # untrained LIDVAE's, whose gradients reach 1e20) are left out of the
    # share, with a margin of 2
    sane = {k: g_ref[k].abs() < ADAM_F32_SQUARE_LIMIT / 2 for k in live}
    share = lambda p, w: float(torch.cat([(p[k] - w[k]).abs()[sane[k]] for k in live])
                               .gt(LR / 10).float().mean())
    overflow = sum(int((~v).sum()) for v in sane.values())
    rel = max(abs(t_dev[k] - t_cpu[k]) / max(abs(t_cpu[k]), 1e-12) for k in t_cpu)
    stats = max(float((b_dev[k] - b_cpu[k]).abs().max()) / max(1.0, float(b_cpu[k].abs().max()))
                for k in b_cpu)
    checks = {
        "loss terms, card f32 vs CPU f32": (rel, FLEX_REF_LOSS_RTOL),
        "statistics, card f32 vs CPU f32": (stats, REF_BN_TOL),
        "gradient, card float64 vs CPU float64, every leaf": (gap(g_dev64, g_64, list(g_64)),
                                                               FLEX_F64_GRAD_RTOL),
        f"gradient, card f32 vs CPU float64 on the card's pieces, {len(live)} leaves": (
            gap(g_dev, g_ref, live), f32_rtol),
        "moved share, card f32 vs CPU float64 on the card's pieces": (share(p_dev, p_ref),
                                                                     REF_F32_MOVED_SHARE)}
    flips = sum(int((a != b).sum()) for a, b in zip(card_signs, signs_64))
    print(f"reference train step {tag}: " + "; ".join(
        f"{name} {v:.3e} (bound {b:g})" for name, (v, b) in checks.items())
        + f"; {overflow} gradient elements above sqrt(f32 max) / 2 left out of the moved share"
        + f"; LeakyReLU inputs on the other side of 0 in the card's f32 step than in the CPU's "
        f"float64 step: {flips} of {sum(a.numel() for a in signs_64)}; f32 gradient from the "
        f"float64 step on its own pieces: card {gap(g_dev, g_64, live):.3e}, CPU "
        f"{gap(g_cpu, g_64, live):.3e}; cpu {t_cpu} card {t_dev}")
    if tf32_probe:
        with mock.patch.object(blocks, "_ieee_f32", lambda x: contextlib.nullcontext()):
            (_, g_tf32, p_tf32, _), (_, g_tf32_ref, p_tf32_ref, _), _ = on_pieces(
                lambda: run(dev))
        tf32_gap = gap(g_tf32, g_tf32_ref, live)
        print(f"reference train step {tag}, the port's TF32 override off: f32 gradient from "
              f"the CPU's float64 on its pieces {tf32_gap:.3e} (must exceed the bound "
              f"{f32_rtol:g}), moved share {share(p_tf32, p_tf32_ref):.3e}")
        if not tf32_gap > f32_rtol:
            raise AssertionError(f"{tag}: the f32 bound does not tell TF32 convolutions apart")
    failed = [name for name, (v, b) in checks.items() if not v <= b]
    if failed:
        raise AssertionError(f"card and CPU train steps disagree ({tag}): {failed}")


def phase_flexible(dev):
    """The FlexibleVAE family on the card: the pinwheel config through
    run_experiment (both sweep points, PINWHEEL_EPOCHS epochs), the train
    steps' ms/step and idle share of the pinwheel LR-VAE, the MNIST-config
    MLP LR-VAE and the conv VAE of bench.py:72 (with its eval ms/batch),
    the card against the CPU for one staged LR-VAE step and one conv
    VanillaVAE step (under PyTorch's default cuDNN TF32 setting, which the
    port's f32 convolutions must override). No kernel counter may rise."""
    paths = {}
    config = dict(PINWHEEL_CONFIG, common_params=dict(PINWHEEL_CONFIG["common_params"],
                                                      exp_epochs=PINWHEEL_EPOCHS))
    common, mp = config["common_params"], config["model_params"]
    _reset_launches()
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        summaries = run_experiment(config, output_root=root, seed=SEED, device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        written = [(sorted(os.listdir(os.path.join(s["result_dir"], "params"))),
                    os.path.isdir(os.path.join(s["result_dir"], "scatter2d")),
                    len(os.listdir(os.path.join(root, "runs", s["name"])))) for s in summaries]
        logs = sorted(os.listdir(os.path.join(root, "log")))
        with open(os.path.join(root, "log", logs[0])) as f:
            rows = f.read().strip().splitlines()
    paths["pinwheel_train_and_test"] = _read_launches()
    steps = num_batches(load_dataset("pinwheel", seed=SEED)[0], common["batch_size"])
    epochs_run, full = len(summaries) * PINWHEEL_EPOCHS, PINWHEEL_CONFIG["common_params"]["exp_epochs"]
    print(f"run_experiment pinwheel LR-VAE: {len(summaries)} sweep points x {PINWHEEL_EPOCHS} "
          f"epochs of {steps} steps at B={common['batch_size']} in {wall:.2f} s "
          f"({wall / epochs_run:.3f} s an epoch with its eval and artifacts; the config's "
          f"{full} epochs x {len(summaries)} points would take "
          f"{wall / epochs_run * full * len(summaries) / 3600:.2f} h); wrote "
          f"{written}, log {logs} with {len(rows) - 1} rows; final eval "
          f"{[s['eval'] for s in summaries]}; posterior metrics "
          f"{[s['posterior_metrics'] for s in summaries]}")
    numbers = [v for s in summaries for v in (*s["eval"].values(),
                                               *s["posterior_metrics"].values())]
    if len(summaries) != len(mp["beta_list"]) or not all(math.isfinite(v) for v in numbers):
        raise AssertionError(f"pinwheel run_experiment: non-finite numbers {numbers}")
    if any(w[0] != [f"model_{PINWHEEL_EPOCHS - 1}.pkl"] or w[2] < 1 for w in written) or len(
            rows) != 1 + len(summaries):
        raise AssertionError(f"pinwheel run_experiment did not write its artifacts: {written}")
    _expect_launches(paths["pinwheel_train_and_test"], "the pinwheel trainer", (), COUNTERS)

    beta, alpha = mp["beta_list"][0], mp["alpha_list"][0]
    profiles = {}
    for name, args, evaluate in (
            ("pinwheel_step", ("pinwheel LR-VAE f32", "lrvae", "pinwheel", mp, beta, alpha,
                               common["batch_size"], mp["num_mc_samples"]), False),
            ("mnist_mlp_step", ("MNIST-config MLP LR-VAE f32", "lrvae", "mnist", MNIST_PARAMS,
                                MNIST_PARAMS["beta_list"][0], MNIST_PARAMS["alpha_list"][0],
                                MNIST_BATCH, MNIST_PARAMS["num_mc_samples"]), False),
            ("conv_vae_step", ("conv VAE (bench.py:72) f32", "vae", "mnist", CONV_VAE_PARAMS,
                               1.0, 0.0, CONV_VAE_BATCH, 1), True)):
        _reset_launches()
        profiles[name] = _flex_time(*args, dev, evaluate=evaluate)
        paths[name] = _read_launches()
        _expect_launches(paths[name], name, (), COUNTERS)
    # profiled only after every step and eval was timed
    for name, profile in profiles.items():
        _reset_launches()
        profile()
        _expect_launches(_read_launches(), f"{name} (profiled)", (), COUNTERS)

    _reset_launches()
    _flex_compare(dev, "pinwheel LR-VAE (staged) f32", "lrvae", "pinwheel", mp, beta, alpha,
                  common["batch_size"], mp["num_mc_samples"], FLEX_F32_GRAD_RTOL)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True          # PyTorch's default
    try:
        _flex_compare(dev, "conv VanillaVAE f32, cudnn.allow_tf32 True", "vae", "mnist",
                      CONV_VAE_PARAMS, 1.0, 0.0, CONV_VAE_BATCH, 1, FLEX_CONV_F32_GRAD_RTOL,
                      tf32_probe=True)
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    paths["flexible_reference"] = _read_launches()
    _expect_launches(paths["flexible_reference"], "the flexible reference steps", (), COUNTERS)
    return paths


# Phase 10: LID-VAE and the Lipschitz analysis, which run no kernel of
# the port (JAX runs them through XLA alone). The CLI runs at its full
# data size and grids (10000 points, K = K_z = 16, CELL_PAIRS and
# DATA_PAIRS pairs) for LIPSCHITZ_EPOCHS epochs instead of its 1000, with
# each model at the sweep's flags (seed 42, beta 0.1, protocol B's two
# components). The LIDVAE train step is timed at the CLI's width (MLP
# encoder 64-128-64-2, ICNNs of 512 and 1024, B = 256) and at MNIST's
# (LIDVAE.for_dataset("mnist"): conv encoder 32-64-128, latent 32, ICNNs of
# 512 on 32 inputs and 1024 on 784, B = 256, seeded [0, 1) images).
LIPSCHITZ_EPOCHS = 3
LIPSCHITZ_ARGS = ["--K", "16", "--K_z", "16", "--seed", "42", "--beta", "0.1",
                  "--num_training_components", "2", "--wu_strat", "linear"]
LIPSCHITZ_MODELS = {"lrvae": ["--model", "lrvae", "--alpha", "0.1"],
                    "lidvae": ["--model", "lidvae", "--IL", "0.1"]}
LIDVAE_IL = 0.1
LIDVAE_CLI_PARAMS = {"hchans": [64, 128, 64, 2]}
LIDVAE_BATCH = 256
# The card's analysis against the CPU's, the same weights (the card's
# trained model) and draws, on LIPSCHITZ_REF_POINTS points with 4 x 4
# grids (the CPU's LIDVAE decode of the full grids would take minutes):
# every field and data-based metric within LIPSCHITZ_REF_RTOL of the
# CPU's, relative to the field's largest magnitude (the inverse
# Lipschitz fields as the quantiles they invert; H100: up to 6.8e-5, and
# the LR-VAE's inverse field read as 1/quantile 8.7e-4). The card's LIDVAE
# train step against the CPU's float64 step on the card's LeakyReLU
# pieces: LIDVAE_F32_GRAD_RTOL relative L2 (CPU, small widths: 1.0e-6
# MLP, 3.9e-6 conv; tests/test_torch_lidvae.py), the other bounds of
# phase 9.
LIPSCHITZ_REF_POINTS = 2000
LIPSCHITZ_REF_K = 4
LIPSCHITZ_REF_RTOL = 1e-3
LIDVAE_F32_GRAD_RTOL = 1e-3


def _lipschitz_cli(dev, root, name, flags):
    """cli/lipschitz.main on the card: the CSVs (K^2 + K_z^2 field rows, a
    row appended to exp_lip.csv), finite metrics and X fields; prints the
    training's s/epoch, the analysis' wall time, the peak device memory
    and the projected time of one 1000-epoch sweep point."""
    out = os.path.join(root, name, "run")
    args = lipschitz_cli.build_argparser().parse_args(LIPSCHITZ_ARGS + flags)
    n_rows = args.K ** 2 + args.K_z ** 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = lipschitz_cli.main(LIPSCHITZ_ARGS + flags + [
        "--epochs", str(LIPSCHITZ_EPOCHS), "--output_dir", out, "--device", str(dev)])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    with open(os.path.join(out, "experiment_metrics.csv")) as f:
        rows = [line.split(",") for line in f.read().strip().splitlines()]
    with open(os.path.join(root, name, "exp_lip.csv")) as f:
        exp_lip = f.read().strip().splitlines()
    x_fields = [float(v) for r in rows[1:] if r[1] == "X" for v in r[3:]]
    z_bad = sum(not math.isfinite(float(v)) for r in rows[1:] if r[1] == "Z" for v in r[3:])
    per_epoch = m["train_sec"] / LIPSCHITZ_EPOCHS
    print(f"lipschitz CLI {name}: train {m['train_sec']:.3f} s for {LIPSCHITZ_EPOCHS} epochs "
          f"({per_epoch:.4f} s/epoch, {args.train_total_samples // args.batch_size} steps of "
          f"B={args.batch_size}), analysis {m['analysis_sec']:.3f} s, "
          f"run {wall:.2f} s, peak device memory {peak:.2f} GiB; one 1000-epoch sweep point "
          f"projected {(per_epoch * 1000 + m['analysis_sec']) / 60:.1f} min; data-based KL "
          f"{m['kl']:.6g}, L(z) {m['bi_lips']:.6g} (inv {m['inv_lips']:.6g}, lips "
          f"{m['lips']:.6g}); {len(rows) - 1} field rows, {z_bad} non-finite Z-field values")
    if rows[0] != ["alpha", "space", "cell_idx", "kl_div", "lipschitz"] or len(rows) != 1 + n_rows:
        raise AssertionError(f"{name}: experiment_metrics.csv is not the CLI's: {rows[:2]}")
    if exp_lip != ["alpha,beta,kl,L(z)", exp_lip[1]] or not all(
            math.isfinite(v) for v in (*m.values(), *x_fields)):
        raise AssertionError(f"{name}: non-finite metrics or X fields, or exp_lip {exp_lip}")
    return m


def _lipschitz_reference(dev, name, flags):
    """A model trained on the card for LIPSCHITZ_EPOCHS epochs, then its
    analysis on the card and on the CPU, the same weights and draws."""
    args = lipschitz_cli.build_argparser().parse_args(LIPSCHITZ_ARGS + flags + [
        "--epochs", str(LIPSCHITZ_EPOCHS)])
    X = lipschitz_cli.generate_simple_gaussian_mixture(
        num_components=args.num_training_components, total_samples=args.train_total_samples,
        center_range=args.K, stds=args.std, pattern=args.distribution_pattern, seed=args.seed)[0]
    gen = torch.Generator().manual_seed(args.seed)
    if args.model == "lidvae":
        model = lipschitz_cli.LIDVAE.for_dataset(
            "pinwheel", hidden_channels=tuple(args.hidden_channels), inverse_lipschitz=args.IL,
            beta=args.beta, generator=gen)
    else:
        model = lipschitz_cli.LRVAE.for_dataset(
            "pinwheel", hidden_channels=tuple(args.hidden_channels), encoder_type="mlp",
            decoder_type="mlp", alpha=args.alpha, beta=args.beta, generator=gen)
    lipschitz_cli.train_model(model.to(dev), torch.from_numpy(X).to(dev), args,
                              {"enabled": False}, initial_wu_alpha=1.0,
                              generator=torch.Generator().manual_seed(SEED))
    Xr = X[:LIPSCHITZ_REF_POINTS]
    k = LIPSCHITZ_REF_K
    draws = lipschitz_cli.draw_analysis(torch.Generator().manual_seed(SEED), len(Xr),
                                        model.latent_channel, k, k)
    card = lipschitz_cli.analyse(model, Xr, k, k, draws)
    cpu = lipschitz_cli.analyse(copy.deepcopy(model).cpu(), Xr, k, k, draws)
    gaps = {}
    for key in ("kl_x", "lips_x", "inv_x", "kl_z", "lips_z", "inv_z"):
        a, b = np.asarray(card[key], np.float64), np.asarray(cpu[key], np.float64)
        if key.startswith("inv"):
            # inv is 1 / (the 5% quantile of the ratios), which can sit at
            # the 1e-3 clamp: held as the quantile itself, which is what
            # the analysis computes (1 / inv amplifies its f32 roundoff);
            # bi = max(inv, lips) follows from the two
            a, b = 1.0 / a, 1.0 / b
        both = np.isfinite(a) & np.isfinite(b)
        if not np.array_equal(np.isfinite(a), np.isfinite(b)):
            raise AssertionError(f"{name} analysis: {key} finite on one side only")
        gaps[key] = (float(np.abs(a - b)[both].max() / max(1.0, np.abs(b[both]).max()))
                     if both.any() else 0.0)
    for key in ("data_kl", "data_inv", "data_lips", "data_bi"):
        gaps[key] = abs(card[key] - cpu[key]) / max(abs(cpu[key]), 1e-12)
    worst = max(gaps, key=gaps.get)
    print(f"reference analysis {name} ({len(Xr)} points, {k} x {k} grids, trained "
          f"{LIPSCHITZ_EPOCHS} epochs on the card): card against CPU, largest gap {worst} "
          f"{gaps[worst]:.3e} (bound {LIPSCHITZ_REF_RTOL:g}); " + ", ".join(
              f"{key} {v:.2e}" for key, v in gaps.items()))
    if not gaps[worst] <= LIPSCHITZ_REF_RTOL:
        raise AssertionError(f"{name}: card and CPU analyses disagree: {gaps}")


def phase_lipschitz(dev):
    """LID-VAE and the Lipschitz analysis on the card: cli/lipschitz.main
    for LR-VAE and LIDVAE, the card's analysis held to the CPU's, the
    LIDVAE train step's ms/step and idle share at the CLI's and MNIST's
    widths, and the card's LIDVAE steps held to the CPU's float64 steps
    on their pieces. No kernel counter may rise."""
    paths = {}
    _reset_launches()
    with tempfile.TemporaryDirectory() as root:
        for name, flags in LIPSCHITZ_MODELS.items():
            _lipschitz_cli(dev, root, name, flags)
    paths["lipschitz_cli"] = _read_launches()
    _expect_launches(paths["lipschitz_cli"], "the Lipschitz CLI", (), COUNTERS)

    _reset_launches()
    for name, flags in LIPSCHITZ_MODELS.items():
        _lipschitz_reference(dev, name, flags)
    paths["lipschitz_reference"] = _read_launches()
    _expect_launches(paths["lipschitz_reference"], "the Lipschitz reference", (), COUNTERS)

    _reset_launches()
    widths = (("LIDVAE CLI width f32", "pinwheel", LIDVAE_CLI_PARAMS),
              ("LIDVAE MNIST width f32", "mnist", {}))
    profiles = [_flex_time(tag, "lidvae", dataset, params, 0.1, 0.0, LIDVAE_BATCH, 1, dev,
                           il=LIDVAE_IL) for tag, dataset, params in widths]
    for profile in profiles:
        profile()
    for tag, dataset, params in widths:
        _flex_compare(dev, tag, "lidvae", dataset, params, 0.1, 0.0, LIDVAE_BATCH, 1,
                      LIDVAE_F32_GRAD_RTOL, il=LIDVAE_IL)
    paths["lidvae_steps"] = _read_launches()
    _expect_launches(paths["lidvae_steps"], "the LIDVAE steps", (), COUNTERS)
    return paths


# Phase 11: the image path, which runs no kernel of the port either (JAX runs
# the FlexibleVAE family, the augments, the FID and Inception through XLA
# alone). A literal copy of configs/config_mnist.yaml
# (tests/test_torch_isolation.py holds it to the file): LR-VAE, ten MLP
# blocks of 16, L = 4, B = 256, the staged backward. It runs on the stand-in
# images (MNIST_DATASET: 4096 train, 1024 test, so 16 steps an epoch) with
# the MNIST augment on the card, for MNIST_EPOCHS epochs instead of its 100,
# then in generation-only mode (epochs < 0) from its checkpoint at B = 256:
# 50 batches, 12800 images, and the random-conv FID.
MNIST_CONFIG = {
    "experiment_type": "lrvae",
    "common_params": {
        "exp_data": "mnist",
        "exp_epochs": 100,
        "batch_size": 256,
        "niter": 1,
        "logfilename": None,
        "resultname": None,
        "grad_clip": {"enabled": True, "clip_type": "norm", "max_norm": 1.0,
                      "norm_type": 2.0, "clip_value": 1.0},
    },
    "model_params": {
        "beta_list": [0.001],
        "log_mse": False,
        "encoder_type": "mlp",
        "decoder_type": "mlp",
        "fixed_var": False,
        "residual_connection": False,
        "hchans": [16, 16, 16, 16, 16, 16, 16, 16, 16, 16],
        "num_mc_samples": 4,
        "alpha_list": [0.1],
        "pwise_reg": False,
    },
}
MNIST_DATASET = {"fake": True}      # the config's own comment: no IDX files here
MNIST_EPOCHS = 2
IMAGE_TIMED_STEPS = 10
# Card against CPU on the same inputs. The warp: bilinear weights and four
# products, fused or not, on coordinates < 28 (H100 measured below). The
# random-conv features: three f32 convolutions (IEEE f32 on both sides,
# cuDNN TF32 off) and a mean, relative to max|f|. InceptionV3: 94
# convolutions and the resize, relative to max|f|, 4 images.
IMAGE_WARP_ATOL = 1e-5
IMAGE_FID_FEATURE_RTOL = 1e-5
IMAGE_INCEPTION_RTOL = 1e-4
IMAGE_INCEPTION_IMAGES = 4
INCEPTION_BATCH = 256


def _mnist_config(**common):
    return dict(MNIST_CONFIG, common_params=dict(
        MNIST_CONFIG["common_params"], dataset_params=MNIST_DATASET, **common))


def _mnist_run(dev, root, tag, **common):
    """run_experiment on the MNIST config; its summary, wall time and the
    native loader's batches."""
    before = native.loader_batches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    (summary,) = run_experiment(_mnist_config(**common), output_root=os.path.join(root, tag),
                                seed=SEED, device=dev)
    torch.cuda.synchronize()
    return summary, time.perf_counter() - t0, native.loader_batches - before


def _image_step_ms(dev, augment):
    """The MNIST config's train step, ms/step median over IMAGE_TIMED_STEPS
    steps after two warm-ups, each step ending in a scalar fetch (host
    clock), on the stand-in images, with or without the MNIST augment
    applied on the card before each step."""
    mp = MNIST_CONFIG["model_params"]
    model = _flex_build("lrvae", "mnist", mp, mp["beta_list"][0], mp["alpha_list"][0]).to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    batch = MNIST_CONFIG["common_params"]["batch_size"]
    train, _, aug = load_dataset("mnist", **MNIST_DATASET)
    xs = torch.from_numpy(train.X[:batch * 4]).to(dev).reshape(4, batch, 28, 28, 1)
    eps = torch.randn(4, mp["num_mc_samples"], batch, model.latent_channel,
                      generator=torch.Generator().manual_seed(SEED + 11)).to(dev)
    gen = torch.Generator().manual_seed(SEED + 12)
    times = []
    for i in range(2 + IMAGE_TIMED_STEPS):
        t0 = time.perf_counter()
        x = aug(xs[i % 4], gen) if augment else xs[i % 4]
        loss = float(step(x, eps[i % 4], 0.5)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(loss):
            raise AssertionError(f"MNIST config train step: loss {loss}")
    return statistics.median(times[2:])


def _conv_step_ms(dev, kind, deterministic):
    """ms/step (median of IMAGE_TIMED_STEPS after two warm-ups) of the conv
    VAE of bench.py:72 or LIDVAE.for_dataset("mnist"), B = 256, with cuDNN's
    deterministic algorithms on (the port's convolutions) or off (cuDNN's
    default choice, the port before it took them)."""
    off = mock.patch.object(blocks, "_deterministic", lambda x: contextlib.nullcontext())
    with contextlib.nullcontext() if deterministic else off:
        params, beta, il = (CONV_VAE_PARAMS, 1.0, 0.0) if kind == "vae" else ({}, 0.1, LIDVAE_IL)
        model = _flex_build(kind, "mnist", params, beta, 0.0, il).to(dev)
        step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
        x = torch.from_numpy(_flex_inputs("mnist", CONV_VAE_BATCH, 1, SEED + 13)[0]).to(dev)
        eps = torch.randn(1, CONV_VAE_BATCH, model.latent_channel,
                          generator=torch.Generator().manual_seed(SEED + 14)).to(dev)
        times = []
        for _ in range(2 + IMAGE_TIMED_STEPS):
            t0 = time.perf_counter()
            float(step(x, eps, 0.5)["loss"])
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[2:])


def _image_resume(dev, root, kind):
    """train_and_test of the conv VAE of bench.py:72 or LIDVAE.for_dataset(
    "mnist") on the stand-in MNIST images (with the augment) for 2 epochs,
    and a fresh model resumed from ckpt_0.pkl: the final states must be
    equal bit for bit."""
    batch = MNIST_CONFIG["common_params"]["batch_size"]
    params, beta, il = (CONV_VAE_PARAMS, 1.0, 0.0) if kind == "vae" else ({}, 0.1, LIDVAE_IL)
    kw = dict(epochs=2, batch_size=batch, dataset_name="mnist", dataset_params=MNIST_DATASET,
              seed=SEED, lr=LR, device=dev)
    cont, summary = train_and_test(_flex_build(kind, "mnist", params, beta, 0.0, il),
                                   output_root=os.path.join(root, kind, "a"), checkpoint_every=1,
                                   **kw)
    ckpt = os.path.join(summary["result_dir"], "params", "ckpt_0.pkl")
    model = build_model(kind, "mnist", params, beta=beta, alpha=0.0, il=il,
                        generator=torch.Generator().manual_seed(SEED + 1))
    resumed, _ = train_and_test(model, output_root=os.path.join(root, kind, "b"),
                                resume_from=ckpt, **kw)
    same = _same_state(cont, resumed)
    print(f"resume {type(cont.model).__name__} (mnist, B={batch}, 2 epochs of "
          f"{cont.step // 2} steps with the MNIST augment): resumed from ckpt_0.pkl, final "
          f"parameters, statistics and Adam state bitwise equal to the continuous run's {same}")
    if not same or not all(math.isfinite(v) for v in summary["eval"].values()):
        raise AssertionError(f"{kind}: the resumed run does not end where the continuous run did")


def _image_reference(dev):
    """The card against the CPU on the same inputs: the MNIST warp on the
    same matrices, the flip on the same mask, the random-conv FID features
    (1 and 3 channels) and InceptionV3 with the synthetic state dict."""
    train, _, aug = load_dataset("mnist", **MNIST_DATASET)
    x = torch.from_numpy(train.X[:256])
    draws = aug.draw(torch.Generator().manual_seed(SEED + 15), 256)
    warp = _max_err(aug.apply(x.to(dev), draws).cpu(), aug.apply(x, draws))
    cifar, _, flip_aug = load_dataset("cifar10", **MNIST_DATASET)
    c = torch.from_numpy(cifar.X[:256])
    mask = flip_aug.draw(torch.Generator().manual_seed(SEED + 16), 256)
    flip_same = torch.equal(flip_aug.apply(c.to(dev), mask).cpu(), flip_aug.apply(c, mask))
    gaps = {}
    for name, imgs in (("mnist", x), ("cifar10", c)):
        card = fid_lib.extract(fid_lib.make_conv_feature_extractor(imgs.shape[1:], device=dev),
                               imgs)
        cpu = fid_lib.extract(fid_lib.make_conv_feature_extractor(imgs.shape[1:], device="cpu"),
                              imgs)
        gaps[name] = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    sd = inception.synthetic_state_dict()
    few = x[:IMAGE_INCEPTION_IMAGES]
    card = fid_lib.extract(inception.InceptionV3Features(device=dev, state_dict=sd), few)
    cpu = fid_lib.extract(inception.InceptionV3Features(device="cpu", state_dict=sd), few)
    incep = float(np.abs(card - cpu).max() / np.abs(cpu).max())
    print(f"reference image path, card against CPU: MNIST warp on the same matrices "
          f"{warp:.3e} (bound {IMAGE_WARP_ATOL:g}), flip bitwise {flip_same}, random-conv FID "
          f"features relative {gaps} (bound {IMAGE_FID_FEATURE_RTOL:g}), InceptionV3 "
          f"(synthetic state dict, {IMAGE_INCEPTION_IMAGES} images) relative {incep:.3e} "
          f"(bound {IMAGE_INCEPTION_RTOL:g})")
    if not (warp <= IMAGE_WARP_ATOL and flip_same and incep <= IMAGE_INCEPTION_RTOL
            and max(gaps.values()) <= IMAGE_FID_FEATURE_RTOL):
        raise AssertionError("the card and the CPU disagree on the image path")


def phase_images(dev):
    """The image path on the card: config_mnist.yaml through run_experiment
    with native_prefetch (which must use the native loader) and without,
    then its generation-only mode with the FID; the conv VAE on CIFAR-10's
    stand-in images with the flip; the conv VAE's and LIDVAE's resume
    bitwise; the card against the CPU; the timings. No kernel counter may
    rise."""
    if not native.available():
        raise AssertionError("the native host library did not build on the card's host")
    steps = 4096 // MNIST_CONFIG["common_params"]["batch_size"]
    _reset_launches()
    with tempfile.TemporaryDirectory() as root:
        runs = {}
        for tag, prefetch in (("prefetch", True), ("plain", False), ("prefetch again", True)):
            summary, wall, loaded = _mnist_run(dev, root, tag.replace(" ", "_"),
                                               exp_epochs=MNIST_EPOCHS, native_prefetch=prefetch)
            runs[tag] = summary, wall
            numbers = dict(summary["eval"], **summary["posterior_metrics"])
            print(f"run_experiment config_mnist.yaml ({tag}, native_prefetch {prefetch}): "
                  f"{MNIST_EPOCHS} epochs of {steps} steps at B=256 in {wall:.3f} s "
                  f"({wall / MNIST_EPOCHS:.3f} s an epoch with its eval, artifacts and final "
                  f"metrics); native loader batches {loaded}; final eval {summary['eval']}; "
                  f"posterior metrics {summary['posterior_metrics']}")
            if not all(math.isfinite(v) for v in numbers.values()):
                raise AssertionError(f"config_mnist.yaml ({tag}): non-finite numbers {numbers}")
            if loaded != (MNIST_EPOCHS * steps if prefetch else 0):
                raise AssertionError(f"config_mnist.yaml ({tag}): {loaded} native loader batches")
            written = sorted(os.listdir(os.path.join(summary["result_dir"], "params")))
            if written != [f"model_{MNIST_EPOCHS - 1}.pkl"]:
                raise AssertionError(f"config_mnist.yaml ({tag}) wrote {written}")
        pkl = os.path.join(runs["prefetch"][0]["result_dir"], "params",
                           f"model_{MNIST_EPOCHS - 1}.pkl")
        gen, wall, _ = _mnist_run(dev, root, "generation", exp_epochs=-1, pt_param=pkl)
        print(f"generation-only mode (epochs -1) from {os.path.basename(pkl)}: 50 batches of 256 "
              f"(12800 images) and the random-conv FID {gen['fid']:.6f} in {wall:.3f} s; "
              f"posterior metrics {gen['posterior_metrics']}")
        if not (math.isfinite(gen["fid"]) and gen["fid"] > 0):
            raise AssertionError(f"generation-only mode: FID {gen['fid']}")

        model = build_model("lrvae", "mnist", MNIST_CONFIG["model_params"],
                            beta=MNIST_CONFIG["model_params"]["beta_list"][0],
                            alpha=MNIST_CONFIG["model_params"]["alpha_list"][0])
        ckpt_lib.load_params_only(pkl, model)
        model.to(dev)
        generate_samples(model, 256, 256, seed=SEED)          # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        images = generate_samples(model, 12800, 256, seed=SEED + 1)
        gen_s = time.perf_counter() - t0
        _, test_ds, _ = load_dataset("mnist", **MNIST_DATASET)
        t0 = time.perf_counter()
        score = train_loop._compute_fid(test_ds, np.clip(images, 0, 1), dev)
        fid_s = time.perf_counter() - t0
        print(f"generation: {images.shape[0] / gen_s:.1f} images/s (12800 in {gen_s:.3f} s, "
              f"B=256, host clock, to numpy on the host); FID of 1024 test against 12800 "
              f"generated images {score:.6f} in {fid_s:.3f} s (random-conv features on the card, "
              f"the Frechet distance on the host)")

        cifar = build_model("vae", "cifar10", CONV_VAE_PARAMS, beta=1.0,
                            generator=torch.Generator().manual_seed(SEED))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, summary = train_and_test(cifar, epochs=1, batch_size=CONV_VAE_BATCH,
                                        dataset_name="cifar10", dataset_params=MNIST_DATASET,
                                        seed=SEED, lr=LR, output_root=os.path.join(root, "cifar"),
                                        device=dev)
        torch.cuda.synchronize()
        print(f"train_and_test conv VAE (bench.py:72's, for_dataset cifar10) on the CIFAR-10 "
              f"stand-in images with the flip: 1 epoch of {state.step} steps at "
              f"B={CONV_VAE_BATCH} in {time.perf_counter() - t0:.3f} s; final eval "
              f"{summary['eval']}")
        if not all(math.isfinite(v) for v in summary["eval"].values()):
            raise AssertionError(f"conv VAE on CIFAR-10: {summary['eval']}")
        for kind in ("vae", "lidvae"):
            _image_resume(dev, root, kind)

    _image_reference(dev)
    plain = [_image_step_ms(dev, False)]
    aug = [_image_step_ms(dev, True), _image_step_ms(dev, True)]
    plain.append(_image_step_ms(dev, False))
    print(f"train step config_mnist.yaml (B=256, L=4, staged): {plain[0]:.3f}, {plain[1]:.3f} "
          f"ms/step without the augment, {aug[0]:.3f}, {aug[1]:.3f} ms/step with the MNIST augment "
          f"on the card (median of {IMAGE_TIMED_STEPS} steps, host clock, alternating)")
    for kind in ("vae", "lidvae"):
        off = [_conv_step_ms(dev, kind, False)]
        on = [_conv_step_ms(dev, kind, True), _conv_step_ms(dev, kind, True)]
        off.append(_conv_step_ms(dev, kind, False))
        print(f"train step {'conv VAE (bench.py:72)' if kind == 'vae' else 'LIDVAE mnist'} "
              f"B={CONV_VAE_BATCH}: cuDNN deterministic off {off[0]:.3f}, {off[1]:.3f} ms/step, "
              f"on {on[0]:.3f}, {on[1]:.3f} ms/step (median of {IMAGE_TIMED_STEPS}, "
              f"alternating)")
    sd = inception.synthetic_state_dict()
    extractor = inception.InceptionV3Features(device=dev, state_dict=sd)
    x = torch.from_numpy(load_dataset("mnist", **MNIST_DATASET)[0].X[:INCEPTION_BATCH]).to(dev)
    fid_lib.extract(extractor, x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(4):
        fid_lib.extract(extractor, x)
    incep_s = time.perf_counter() - t0
    print(f"InceptionV3 pool3 (synthetic state dict, f32): {4 * INCEPTION_BATCH / incep_s:.1f} "
          f"features/s (4 batches of {INCEPTION_BATCH} MNIST images resized to 299, host clock, "
          f"to numpy)")
    launches = _read_launches()
    _expect_launches(launches, "the image path", (), COUNTERS)
    return launches


def _timed(fn, *args):
    """fn(*args), then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"-- {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    phase_environment()
    dev = torch.device("cuda", 0)
    _timed(phase_build)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1, k2 = _timed(check_attention, dev, gen, "dense_attn (packed route)",
                    denseattn.dense_attention_fwd, denseattn.dense_attention_bwd, K1_CASES,
                    K1_F32_TOL)
    k3f, k3b = _timed(check_attention, dev, gen, "dense_attn (BHND route)",
                      denseattn.dense_attention_bhnd, denseattn.dense_attention_bwd_bhnd,
                      K3_CASES, K3_F32_O_TOL)
    k4 = _timed(check_chamfer, dev, gen)
    k5 = _timed(check_chamfer_bwd, dev, gen)
    k6f, k6b = _timed(check_ffn, dev, gen)
    _timed(phase_eval_generation, dev)
    main_path = _timed(phase_train, dev)
    heads2 = _timed(phase_heads2, dev)
    fused = _timed(phase_fused_ffn, dev)
    _timed(phase_routes, dev)
    _timed(phase_reference, dev)
    paths = {"deepsets": _timed(phase_deepsets, dev)}
    paths["dropout_train"], paths["dropout_eval"] = _timed(phase_dropout, dev)
    paths["trainer_options"] = _timed(phase_trainer_options, dev)
    paths.update(_timed(phase_flexible, dev))
    paths.update(_timed(phase_lipschitz, dev))
    paths["image_path"] = _timed(phase_images, dev)
    rows = (
        ("dense_attn_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:408", main_path, k1),
        ("dense_attn_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:433", main_path, k2),
        ("dense_attn_bhnd_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:124", heads2,
         k3f),
        ("dense_attn_bhnd_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:152", heads2,
         k3b),
        ("chamfer_nn_packed", "chamfer_fwd.cu", "vae_song_tpu/ops/chamfer.py:103", main_path, k4),
        ("chamfer_bwd", "chamfer_bwd.cu", "vae_song_tpu/ops/chamfer.py:161", main_path, k5),
        ("ffn_fwd", "ffn_fwd.cu", "vae_song_tpu/ops/ffn.py:86", fused, k6f),
        ("ffn_bwd", "ffn_bwd.cu", "vae_song_tpu/ops/ffn.py:104", fused, k6b),
    )
    kernels = [dict(name=name, route="cuda", source=f"vae_song_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=launches[name], **numbers,
                    paths={path: counts[name] for path, counts in paths.items()})
               for name, src, replaces, launches, numbers in rows]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
