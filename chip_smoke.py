"""Smoke run of the PyTorch port (vae_song_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a
non-zero exit code:

  1. environment: a CUDA card is required; prints its name and power
     limit (nvidia-smi) and turns TF32 off.
  2. build: compiles the kernels from vae_song_tpu_torch/csrc with nvcc,
     while the nvcc jobs of phase 3b's arms library run beside them.
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
     config (heads of 192 to 4096, FFN widths of 384 and 512; the f32 FFN,
     split TF32, also on inputs whose products need the split, at the f32
     VST_FUSED_FFN=1 path's M = 131072 and at D = 384, F = 1536, held to
     a float64 version and no farther from it than the plain version,
     beside the split-TF32 and FMA bounds); K1, K2,
     K4 and K5 also at phase 8's microbatch of 32 clouds. No kernel
     uses floating-point atomics: a second call on the same inputs must
     give the same bits. Beside the fused FFN the unfused Dense -> ReLU -> Dense
     (forward, and forward + backward) and, forward only (PyTorch has no
     backward for it), cuBLASLt's bias + ReLU epilogue
     (`torch._addmm_activation`, then `addmm` and the residual add) are
     timed as references. The f32 attention cases (B = 4, the f32 path's
     B = 64, N = 192 and, after the other attention cases, from a generator
     of their own, the decoder's B = 1, on both routes at D = 64 and 128,
     the split-TF32 wgmma kernels that keep the scores on chip; on the
     BHND route the
     kernels for heads of 192 and wider at the f32 num_heads 1 path's
     shape, B = 64, D = 256, at N = 192, at two heads of 192, and at one
     head of 512 with B = 1 and 8; all split TF32) hold their gradients
     to a float64 version of the function (the plain version's own f32
     sums stray past the bound at D = 256), and their O and gradients
     must lie no farther from float64 than the plain version's; they
     also print the kernel's and the plain version's distance from the
     float64 version, the split-TF32 bound (3 x operations at 495
     TFLOP/s, the f32 rows' bound_ms) beside the FMA bound (operations at
     67), and SDPA's f32 times with the backend it picks and with
     EFFICIENT_ATTENTION forced. The bf16 heads of 192 and 256 (the
     wgmma kernels of the bf16 num_heads 1 path) run at that path's
     shape, B = 64, D = 256, at two heads of 192, at N = 192 (an odd
     number of 64-row tiles) and at the decoder's B = 1. The bf16 heads
     of 320 to 512 (the wgmma kernels of the bf16 d_model 512, num_heads 1
     path) run at that path's shape, B = 64, D = 512, at its decoder's
     B = 1, and at B = 8 with heads of 320 and 512. The bf16 heads of 576
     to 2048 (the cluster kernels of the bf16 d_model 768, num_heads 1
     path: a thread-block cluster of 3, 4 or 8 CTAs splits the head) run
     at that path's shape, B = 64, D = 768, at its decoder's B = 1, at N =
     192, at B = 8 with heads of 576 (clusters of 3) and 1024 (4), and at
     B = 2 with a head of 1600 (8, uneven); before them phase 3 prints, for
     each cluster size, how many clusters of each cluster kernel the card
     holds at once (cudaOccupancyMaxActiveClusters) and fails if one does
     not fit. The bf16 heads wider than 2048 (the wgmma/TMA kernels over
     written-out scores of the bf16 d_model 2304, num_heads 1 path) run at
     that path's shape, B = 64, D = 2304, at its decoder's B = 1, at N =
     192 with B = 8 and D = 2112 (an odd panel count, D % 128 != 0, an odd
     number of 64-row tiles), at B = 8 with D = 2112, at B = 2 with two
     heads of 2176, and at B = 1, N = 1024 with a head of 4096.
  3b. the attention A/B arms (scripts/ab_attn_arms.py): the compile-time
     arms of K1 and K2's wgmma kernels that port the TPU ablation kernels
     of scripts/ab_attn_ablate*.py and ab_attn_bwd.py, built from
     scripts/ab_attn_arms.cu into build/ab_attn_arms/ (ptxas's lines for
     their kernels printed). At the main path's shape (B = 64, N = 2048,
     4 heads of 64, bf16) and at B = 1: each exact arm (K2's row-constant
     folds dfuse, lfuse, bfuse, fused-e16, fused-e32; K1's bf16max) against
     its plain version at phase 3's bf16 bounds, bitwise from run to run
     and unequal to the package's kernel somewhere; the outputs a strip
     keeps (K2's nodp and nodsmul dV, nodq dK and dV, nodk dQ and dV; K1's
     nopv LSE2) and K1 at NC = 1 and 2 bitwise equal to the package's
     kernels (K2's noexp and K1's noexp, nomax and sonly keep no output
     and are timed only); every arm timed beside the package's
     kernel, its plain version, its bound and SDPA. Then, the counts set
     to 0 just before, every arm in the SetVAE B = 64 step (each K2 arm
     put in place of the backward's launcher for 3 train steps, each K1
     arm of the forward's for 3 eval steps, a fresh model each; exact arms
     must give finite loss terms): each arm must launch.
  4. eval and generation: the shipped ShapeNet SetVAE config at full
     width (B = 64 clouds of N = 2048 points, bf16), random weights from
     a seed: the eval step on 4 batches after a warm-up, then generation
     of 4 batches of 64 clouds. The K1 and K4 launch counters must rise.
  4b. training, the main path: `train_and_test` on the shipped SetVAE
     config (fake clouds: 256 train, 64 test, so 4 steps an epoch), 2
     epochs into a temporary directory; every loss term finite, the
     artifacts written, and the K1, K2, K4 and K5 launch counters must
     all rise. Then ms/step of `make_train_step` for SetVAE (B = 64) and
     SetLRVAE (its config's B = 16) on the host clock, and for SetVAE at
     B = 64 with `mixed_precision: false` (the f32 path), whose K1, K2, K4
     and K5 counters must rise, every K1 and K2 launch on the f32 kernels
     for heads of 64 and 128 (their own counters).
  4c. the two further paths at full width: (1) the shipped SetVAE config
     with `num_heads: 2` (head width 128, the BHND route): one fake-data
     epoch of `train_and_test`, then the eval step's ms/batch and the
     train step's ms/step; the K3f and K3b counters must rise and K1 and
     K2 must not launch. (2) the shipped SetVAE and SetLRVAE configs with
     VST_FUSED_FFN=1 (set and unset here): the train step's ms/step and
     the eval step's ms/batch; the K6f and K6b counters must rise. (3)
     the shipped SetVAE config with `num_heads: 1` and `mixed_precision:
     false` (one f32 head of 256): one fake-data epoch of
     `train_and_test`, then the train step's ms/step; K3f and K3b must
     launch, every launch on the kernels for f32 heads of 192 and wider
     (their own counters), K4 and K5 too, and K1, K2 and the FFN kernels
     must not. (4) the shipped SetVAE config with `num_heads: 1` (one
     bf16 head of 256): one fake-data epoch of `train_and_test`, then the
     eval step's ms/batch and the train step's ms/step; K3f and K3b must
     launch, every launch on the bf16 wgmma kernels for heads of 192 and
     256 (their own counters), K4 and K5 too, and K1, K2, the FFN kernels
     and the f32 kernels for wide heads must not. (5) the shipped SetVAE
     config with `d_model: 512, num_heads: 1` (one bf16 head of 512): the
     same as (4), every K3f and K3b launch on the bf16 wgmma kernels for
     heads of 320 to 512 (their own counters), K4 and K5 too, and no
     other kernel. (6) the shipped SetVAE config with `d_model: 768,
     num_heads: 1` (one bf16 head of 768): the same, every K3f and K3b
     launch on the cluster kernels for heads of 576 to 2048 (their own
     counters), K4 and K5 too, and no other kernel. (7) the shipped
     SetVAE config with `d_model: 2304, num_heads: 1` (one bf16 head of
     2304): the same, every K3f and K3b launch on the kernels over
     written-out scores for heads wider than 2048 (their own counters), K4
     and K5 too, and no other kernel; then the peak device memory of its
     steps. (8) the shipped SetVAE config with `mixed_precision: false` and
     VST_FUSED_FFN=1: one fake-data epoch of `train_and_test`, the train
     step's ms/step beside the same call's f32 step without the fused FFN
     (4b), and the eval step's ms/batch; K1, K2, K4, K5, K6f and K6b must
     launch, every K6f and K6b launch on the split-TF32 kernels (their own
     counters), and no other kernel.
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
     updated parameters), for the shipped SetVAE config and for the
     configurations of phase 4c (num_heads 1 in both, each precision
     running its own kernels for wide heads; d_model 512 with one head in
     bf16, on the kernels for heads of 320 to 512; d_model 768 with one
     head in bf16, on the cluster kernels; d_model 2304 with one head in
     bf16, on the kernels over written-out scores; VST_FUSED_FFN=1 in both,
     f32 on the split-TF32 FFN kernels).
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

  12. the rest of the single-device surface, after phase 11's image path:
     (1) the shipped SetVAE config with `moe_experts: 4` (the top-1 MoE FFN
     in every transformer layer, B = 64, N = 2048, bf16): train ms/step
     (median and spread) and peak memory, K1, K2, K4 and K5 rising by the
     launches its steps count; card against CPU at 8 clouds of 256 points
     (one train step, f32 and bf16) and the share of tokens the router
     sends to the same expert slot on both; (2) `remat: true` on the
     shipped config: ms/step and peak memory with and without, the loss
     terms of one step equal and the gradients within the bf16 bound, K1
     rising by one launch a recomputed self-attention layer a step; the
     same with `attn_dropout: 0.1` (peak memory beside the run without
     remat); (3) the shipped SetVAE decoded in int8 (`generate_samples(...,
     quant="int8")`): clouds/s beside the float decode, its relative
     error against it under the JAX package's 0.05, K1 launching, and the
     int32 products of `torch._int_mm` bitwise equal to the CPU's at the
     decode's shapes; (4) the complexity CLI on the stand-in MNIST images
     for 1 epoch and (5) a `profile_dir` run of `train_and_test` whose
     trace holds the card's kernels; no counter rises on (4) and (5).

  13. the batch- and weight-sharding strategies (parallel/) in a one-rank
     NCCL process group the phase opens on the card (a free localhost
     port) and closes: for the shipped SetVAE (B = 64, bf16) and SetLRVAE
     (B = 16) configs, one train step of the data-parallel step
     (DistributedDataParallel), the FSDP step (FSDP2), the TP step
     (DTensor, the plan on a 1 x 1 mesh) and the TP x FSDP step from the
     single-device step's weights, clouds and noise, each held to the
     single-device step on the card (loss terms, gradients, updated
     parameters, BatchNorm statistics) with PARALLEL_BOUNDS; K1, K2, K4
     and K5 must launch under each wrapper and no other kernel or plain
     attention; each wrapper's ms/step beside the plain step's; then
     `train_and_test` with `fsdp: true` for 2 epochs with checkpoint_every
     1, and its ckpt_0.pkl resumed single-device, which must land on the
     FSDP run. One card cannot hold two NCCL ranks: multi-rank semantics
     are the CPU tests' (gloo).

  14. sequence, pipeline and expert parallelism (parallel/sp.py, pp.py,
     pp_setvae.py, ep.py) in a one-rank NCCL group the phase opens and
     closes: for the shipped SetVAE (B = 64, bf16) and SetLRVAE (B = 16),
     one train step of the SP step (all-gather, then ring), the PP step
     (one stage, the trainer's microbatch rule) and the EP step (one
     expert, `moe_experts: 1`) from the plain step's weights, clouds and
     noise, against the plain step of the same model: PP and EP with
     PARALLEL_BOUNDS (and whether bitwise equal), launching the plain
     step's K1, K2, K4 and K5 as many times; SP with the kernel-against-
     plain bounds, launching no kernel and running plain attention, its
     peak device memory printed (B = 32 where B = 64 does not fit); each
     step's ms/step beside the plain step's; then `train_and_test` with
     `sequence_parallel` and with `pipeline_parallel` for one epoch on a
     1 x 1 mesh (their mesh-shape rule patched to the one rank).

The kernels' JSON line reports, for each kernel, its launches on the
path that runs it (phase 4b for K1, K2, K4, K5, and for the f32 kernels
for heads of 64 and 128, the rows `dense_attn_tf32_narrow_fwd` and `_bwd`,
at the f32 path's B = 64, D = 64 case, their largest error over the f32
cases of both routes at D = 64 and 128, launches from 4b's f32 step; 4c
for K3f, K3b, K6f, K6b, and for the f32 kernels for heads of 192 and
wider, the rows
`dense_attn_tf32_wide_fwd` and `_bwd`, the bf16 wgmma kernels for
heads of 192 and 256, the rows `dense_attn_wgmma_wide_fwd` and `_bwd`,
each at its num_heads 1 path's B = 64, D = 256 case, launches from 4c (3)
and 4c (4), and the bf16 wgmma kernels for heads of 320 to 512, the rows
`dense_attn_wgmma_wider_fwd` and `_bwd`, at the d_model 512 path's B = 64,
D = 512 case, launches from 4c (5), and the bf16 cluster kernels for
heads of 576 to 2048, the rows `dense_attn_wgmma_cluster_fwd` and `_bwd`,
at the d_model 768 path's B = 64, D = 768 case, launches from 4c (6),
and the bf16 kernels over written-out scores for heads wider than 2048,
the rows `dense_attn_wgmma_scores_fwd` and `_bwd`, at the d_model 2304
path's B = 64, D = 2304 case, launches from 4c (7), and the f32
split-TF32 FFN kernels, the rows `ffn_tf32_fwd` and `_bwd`, at the f32
path's M = 131072 case, launches from 4c (8)),
the numbers phase 3 measured and the bound it computed, and under `paths`
its launches on each path of phases 6-14 (zero on phases 9-11); then a
row for each family of phase 3b's arms (one a TPU script function,
`replaces` its file:line): launches from phase 3b's SetVAE steps, the
numbers of the family's first arm at B = 64 (a strip's max_abs_err that of
its kept outputs against the package's kernel, null for an arm that keeps
none, the family's the largest of its arms'; the bound that of the
function it computes) and under `arms` each arm's.
The last two lines are that JSON line and the result line.
"""

import contextlib
import copy
import gc
import importlib.util
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch
from torch.distributed.device_mesh import init_device_mesh

from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.cli import complexity as complexity_cli
from vae_song_tpu_torch.cli import lipschitz as lipschitz_cli
from vae_song_tpu_torch.cli.generate import generate_samples
from vae_song_tpu_torch.cli.main import run_experiment
from vae_song_tpu_torch.data import load_dataset, native
from vae_song_tpu_torch.data.pipeline import num_batches
from vae_song_tpu_torch.data.shapenet import fake_point_clouds
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn import blocks
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.nn.sync import full_tensor
from vae_song_tpu_torch.ops import attention as attention_lib
from vae_song_tpu_torch.ops import chamfer, denseattn, ffn, inception
from vae_song_tpu_torch.ops import fid as fid_lib
from vae_song_tpu_torch.parallel import ep
from vae_song_tpu_torch.parallel import fsdp as fsdp_lib
from vae_song_tpu_torch.parallel import mesh as mesh_lib
from vae_song_tpu_torch.parallel import pp, pp_setvae, sp
from vae_song_tpu_torch.parallel import tp as tp_lib
from vae_song_tpu_torch.serving import quant
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
# The f32 path with one head of 256 (d_model 256): the BHND route's f32
# kernels for heads of 192 and wider (csrc/dense_attn_tf32_wide.cu), held
# to the file by the same test.
HEADS1_F32_OVERRIDE = {"num_heads": 1, "mixed_precision": False}
# The same head of 256 in bf16: the BHND route's wgmma kernels for heads
# of 192 and 256, held to the file by the same test.
HEADS1_BF16_OVERRIDE = {"num_heads": 1}
# the same config at d_model 512 with one head: one bf16 head of 512,
# the BHND route's kernels for heads of 320 to 512 (phase 4c (5))
HEADS1_WIDER_OVERRIDE = {"d_model": 512, "num_heads": 1}
# the same config at d_model 768 with one head: one bf16 head of 768,
# the BHND route's cluster kernels for heads of 576 to 2048 (phase 4c (6))
HEADS1_CLUSTER_OVERRIDE = {"d_model": 768, "num_heads": 1}
# the same config at d_model 2304 with one head: one bf16 head of 2304 (36
# panels of 64), the BHND route's kernels over written-out scores for
# heads wider than 2048 (phase 4c (7))
HEADS1_SCORES_OVERRIDE = {"d_model": 2304, "num_heads": 1}
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
# bf16 tensor cores, float32 outside the tensor cores, TF32 tensor cores,
# HBM3 bandwidth. A kernel's bound is the larger of its operations over
# the peak of their type and its bytes (each input read once, each output
# written once) over the bandwidth. The f32 attention kernels compute in
# split TF32 (three TF32 products a product, csrc/mma_tf32.cuh), so their
# bound is the split-TF32 one, 3 x operations / PEAK_TF32; their f32 rows
# also print the FMA bound, operations / PEAK_F32, beside it.
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_TF32 = 495e12
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
# K1's bf16max arm (phase 3b) rounds the scores themselves to bf16 before
# the max, so where the kernel's f32 S2 and the plain version's (summed in
# other orders) round to neighbouring bf16 values, an exponent moves by one
# bf16 ulp of |S2|, at most 2^-7 |S2|, and LSE2 (>= max S2) with it:
# bound 2^-7 of max(1, max|LSE2|). Measured (H100, B = 64): 0.104 at
# max|LSE2| 39, where K1_BF16_LSE_TOL gives 0.039. Its O is held to
# K1_BF16_O_TOL.
K1_BF16MAX_LSE_TOL = 2.0 ** -7
# f32 attention: same math; the kernels take every product in split TF32
# (f32-accurate: three TF32 products, each chain of at most 32 columns of
# a score or 64 keys or queries of an output into a fresh accumulator);
# the sums run in another order than the plain version's.
# One-pass TF32 lands 11-270x outside these f32 bounds
# (tests/test_torch_denseattn_f32split.py), so they tell the two apart.
# Measured (H100, B = 64, N = 2048, D = 64): the kernel's O 6.2e-6 from a
# float64 version, the plain version's 1.1e-5; kernel against plain
# 1.20e-5 at max|O| 4.8.
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
# Attention backward. bf16, kernel against plain version on the same
# inputs: the tensor cores and the plain f32 einsum sum S and dP in other
# orders, so a rounded exp2 argument or dP can land one bf16 ulp apart;
# dq/dk/dv round to bf16 at the end (measured: one output ulp, 0.031 at
# max|d| ~ 10); bound 2^-6 of max|d|. f32, kernel against a float64
# version of the function (_attn_bwd_f64): split-TF32 products (see
# K1_F32_TOL), summation order; measured (H100, B = 64, N = 2048) the
# kernel within 2.1e-5 at max|d| ~ 10 at D = 64 to 256, the plain f32
# version within 5.4e-5 at D <= 128 but 7.9e-5 at max|dK| 8.6 at D = 256
# (its f32 sums over 256 columns and 2048 rows), so kernel against plain
# strays past this bound there on the plain version's account; bound
# 1e-5 of max|d|. Both routes.
K2_BF16_TOL = 2.0 ** -6
K2_F32_TOL = 1e-5
# f32 heads wider than 256, backward: S2 and dP^T are sums of D products;
# at D = 512 a few ulps on |S2| ~ 36 (ulp 3.8e-6) come through the exp2
# into P and dS (measured, H100, an f32 FMA kernel against the plain
# version: 1.25e-5 of max|dV| at B = 1, N = 256, against 1e-5): bound
# 3e-5 of max|d|, K3_F32_O_TOL's reasoning for O.
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
# 0, bitwise, in both dtypes (f32 on the split-TF32 kernels too).
# The f32 cases of K6_F32_CASES take x, W1 and b1 on the grid (the same
# mask everywhere) but dy, W2 and b2 at full f32 mantissa, so that every
# other product needs the small half of the split (one-pass TF32 misses
# K6_F32_TOL there 18-37x, tests/test_torch_ffn_f32split.py); they are held
# to a float64 version of the function and must lie no farther from it
# than the plain version.
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
# The f32 cases: B = 4 (the parent's times compare directly), the f32
# path's B = 64 (`mixed_precision: false`), and N = 192 at B = 64.
K1_F32_PATH_CASE = (BATCH, NPTS, 4, 64, torch.float32)
K1_CASES = ((BATCH, NPTS, 4, 64, torch.bfloat16), (1, NPTS, 4, 64, torch.bfloat16),
            (MICRO_BATCH, NPTS, 4, 64, torch.bfloat16),
            (BATCH, 192, 4, 64, torch.bfloat16), (4, NPTS, 4, 64, torch.float32),
            K1_F32_PATH_CASE, (BATCH, 192, 4, 64, torch.float32))
# The f32 kernels at 64 and 128 at the decoder's batch-constant layer, B =
# 1, on each route: checked after K1_CASES and K3_CASES from a generator of
# their own, so the inputs of every later check stay those the earlier
# case lists draw.
F32_B1_CASES = ((1, NPTS, 4, 64, torch.float32), (1, NPTS, 2, 128, torch.float32))
# K4 and K5 at the main path's batch, then at phase 8's microbatch
CHAMFER_BATCHES = (BATCH, MICRO_BATCH)
# The f32 kernels for heads of 192 and wider at the shape of the f32
# num_heads 1 path (phase 4c): the JSON line's rows for them report it.
TF32_WIDE_CASE = (BATCH, NPTS, 1, 256, torch.float32)
# The bf16 wgmma kernels for heads of 192 and 256 at the shape of the bf16
# num_heads 1 path (phase 4c): the JSON line's rows for them report it.
WGMMA_WIDE_CASE = (BATCH, NPTS, 1, 256, torch.bfloat16)
# The bf16 wgmma kernels for heads of 320 to 512 at the shape of the bf16
# d_model 512, num_heads 1 path (phase 4c): the JSON line's rows for them
# report it.
WGMMA_WIDER_CASE = (BATCH, NPTS, 1, 512, torch.bfloat16)
# The bf16 cluster kernels for heads of 576 to 2048 at the shape of the
# bf16 d_model 768, num_heads 1 path (phase 4c): the JSON line's rows for
# them report it.
WGMMA_CLUSTER_CASE = (BATCH, NPTS, 1, 768, torch.bfloat16)
# The bf16 kernels over written-out scores for heads wider than 2048 at the
# shape of the bf16 d_model 2304, num_heads 1 path (phase 4c): the JSON
# line's rows for them report it.
WGMMA_SCORES_CASE = (BATCH, NPTS, 1, 2304, torch.bfloat16)
K3_CASES = ((BATCH, NPTS, 2, 128, torch.bfloat16), WGMMA_WIDE_CASE,
            (BATCH, NPTS, 3, 64, torch.bfloat16), (BATCH, 192, 2, 128, torch.bfloat16),
            # bf16 heads of 192 and 256: two heads of 192, an odd number of
            # 64-row tiles, the decoder's batch-constant layer
            (BATCH, NPTS, 2, 192, torch.bfloat16), (BATCH, 192, 1, 256, torch.bfloat16),
            (1, NPTS, 1, 256, torch.bfloat16),
            (4, NPTS, 2, 128, torch.float32), (BATCH, NPTS, 2, 128, torch.float32),
            (BATCH, 192, 2, 128, torch.float32),
            # f32 heads of 192 and wider: the num_heads 1 path's shape, an
            # odd number of 64-row tiles, two heads of 192
            TF32_WIDE_CASE, (BATCH, 192, 1, 256, torch.float32),
            (BATCH, NPTS, 2, 192, torch.float32),
            # bf16 heads of 320 to 512: the d_model 512, num_heads 1 path's
            # shape, its decoder's batch-constant layer, B = 8 at 320 and 512
            WGMMA_WIDER_CASE, (1, NPTS, 1, 512, torch.bfloat16),
            (8, NPTS, 1, 320, torch.bfloat16), (8, NPTS, 1, 512, torch.bfloat16),
            # bf16 heads of 576 to 2048, the cluster kernels: the d_model 768,
            # num_heads 1 path's shape, its decoder's batch-constant layer, an
            # odd number of 64-row tiles, clusters of 3 (panels 3 + 3 + 3), 4
            # (4 x 4) and 8 (P = 25: 3 panels a CTA, 4 in the last)
            WGMMA_CLUSTER_CASE, (1, NPTS, 1, 768, torch.bfloat16),
            (8, 192, 1, 768, torch.bfloat16), (8, NPTS, 1, 576, torch.bfloat16),
            (8, NPTS, 1, 1024, torch.bfloat16), (2, NPTS, 1, 1600, torch.bfloat16),
            # bf16 above 2048, the kernels over written-out scores: the
            # d_model 2304, num_heads 1 path's shape, its decoder's
            # batch-constant layer, an odd panel count (33: the last
            # 128-column tile half past D) with an odd number of 64-row
            # tiles, the same width at the full length, two heads, and a
            # head of 4096 (no width limit)
            WGMMA_SCORES_CASE, (1, NPTS, 1, 2304, torch.bfloat16),
            (8, 192, 1, 2112, torch.bfloat16), (8, NPTS, 1, 2112, torch.bfloat16),
            (2, NPTS, 2, 2176, torch.bfloat16), (1, 1024, 1, 4096, torch.bfloat16),
            # f32 heads of 512, and N = 192 with D = 320: tiles whose last 128
            # rows and last 128 columns both end 64 past N and D
            (1, NPTS, 1, 512, torch.float32), (8, NPTS, 1, 512, torch.float32),
            (8, 192, 1, 320, torch.float32))
# fused FFN shapes (M, D, F, dtype): the main path's M = B * N rows at
# the shipped widths, wider models' widths, then a smaller M in f32
K6_CASES = ((BATCH * 2048, 256, 512, torch.bfloat16), (16 * 2048, 384, 1536, torch.bfloat16),
            (16 * 2048, 512, 2048, torch.bfloat16), (8192, 256, 512, torch.float32))
# f32 on the inputs that need the split (M, D, F), held to float64: the
# shape of the f32 VST_FUSED_FFN=1 path (phase 4c (8)), whose numbers the
# JSON line's ffn_tf32_* rows report, and a wider model's widths
K6_F32_PATH_CASE = (BATCH * NPTS, 256, 512)
K6_F32_CASES = (K6_F32_PATH_CASE, (8192, 384, 1536))
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


def _bound(flops: float, nbytes: float, dtype, peak=None) -> dict:
    """{"bound_ms", "bound_by"} for `flops` operations of `dtype` (at
    `peak` operations a second, if given) and `nbytes` of device-memory
    traffic."""
    peak = peak or (PEAK_BF16 if dtype == torch.bfloat16 else PEAK_F32)
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


def _attn_fwd_f64(q, k, v, scale):
    """The attention forward of f32 q, k, v computed in float64 (qc
    rounded to f32, as the function states; every later step in float64):
    (O [B, N, H, D], LSE2 [B, H, N]) in float64."""
    qc = (q.float() * (scale * denseattn.LOG2E)).double()
    outs, lses = [], []
    for s0 in range(0, q.shape[0], 16):
        sl = slice(s0, s0 + 16)
        s = torch.einsum("bqhd,bkhd->bhqk", qc[sl], k[sl].double())
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp2(s - m)
        l = p.sum(dim=-1)
        o = torch.einsum("bhqk,bkhd->bqhd", p, v[sl].double())
        outs.append(o / l.permute(0, 2, 1)[..., None])
        lses.append(m[..., 0] + torch.log2(l))
    return torch.cat(outs), torch.cat(lses)


def _attn_bwd_f64(q, k, v, o, lse, do, scale):
    """The attention backward of f32 inputs (O and LSE2 those given)
    computed in float64, qc rounded to f32: (dq, dk, dv) in float64."""
    qc = (q.float() * (scale * denseattn.LOG2E)).double()
    delta = (do.double() * o.double()).sum(dim=-1).permute(0, 2, 1)
    dqs, dks, dvs = [], [], []
    for s0 in range(0, q.shape[0], 16):
        sl = slice(s0, s0 + 16)
        kd, vd, dod = k[sl].double(), v[sl].double(), do[sl].double()
        p = torch.exp2(torch.einsum("bqhd,bkhd->bhqk", qc[sl], kd) - lse[sl].double()[..., None])
        dp = torch.einsum("bqhd,bkhd->bhqk", dod, vd)
        ds = p * (dp - delta[sl][..., None])
        dvs.append(torch.einsum("bhqk,bqhd->bkhd", p, dod))
        dqs.append(torch.einsum("bhqk,bkhd->bqhd", ds, kd) * scale)
        dks.append(torch.einsum("bhqk,bqhd->bkhd", ds, qc[sl]) * denseattn.LN2)
    return torch.cat(dqs), torch.cat(dks), torch.cat(dvs)


_SDPA_BACKENDS = {b.value: b.name for b in (
    torch.nn.attention.SDPBackend.MATH, torch.nn.attention.SDPBackend.FLASH_ATTENTION,
    torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION,
    torch.nn.attention.SDPBackend.CUDNN_ATTENTION)}


def _sdpa_f32(q, k, v, do, scale):
    """SDPA's f32 yardstick: the backend PyTorch picks for these inputs
    (torch._fused_sdp_choice on the contiguous [B, H, N, D] copies), and
    forward and backward ms with the memory-efficient backend forced
    (sdpa_kernel(EFFICIENT_ATTENTION)), whose f32 GEMMs are split TF32."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    picked = _SDPA_BACKENDS.get(int(torch._fused_sdp_choice(qt, kt, vt, scale=scale)), "other")
    with torch.nn.attention.sdpa_kernel(torch.nn.attention.SDPBackend.EFFICIENT_ATTENTION):
        fwd, bwd, _ = _sdpa_ms(q, k, v, do, scale)
    return picked, fwd, bwd


def _print_f32_attention(name, shape, q, k, v, do, scale, f64, kernel, plain, ms, sdpa):
    """For an f32 case: the kernel's and the plain version's distance from
    the float64 version `f64` (each an (O, LSE, dq, dk, dv) tuple), the
    split-TF32 and FMA bounds beside the kernel's times, and SDPA's f32
    backend and times (the default pick's from _sdpa_ms, the forced
    memory-efficient backend's)."""
    b, n, h, d = shape
    dist = lambda xs: ", ".join(f"{_max_err(x, y):.3e}" for x, y in zip(xs, f64))
    ops_f, ops_b = 4.0 * b * h * n * n * d, 10.0 * b * h * n * n * d
    picked, eff_f, eff_b = _sdpa_f32(q, k, v, do, scale)
    tag = f"{name} B={b} N={n} H={h} D={d} float32"
    print(f"{tag} vs float64: O, LSE, dq, dk, dv kernel {dist(kernel)}, plain {dist(plain)} "
          f"(max| | {', '.join(f'{float(t.abs().max()):.3f}' for t in f64)})")
    print(f"{tag} bounds: fwd split-TF32 {3 * ops_f / PEAK_TF32 * 1e3:.4f} ms, FMA "
          f"{ops_f / PEAK_F32 * 1e3:.4f} ms (kernel {ms[0]:.4f}); bwd split-TF32 "
          f"{3 * ops_b / PEAK_TF32 * 1e3:.4f} ms, FMA {ops_b / PEAK_F32 * 1e3:.4f} ms (kernel "
          f"{ms[1]:.4f}); sdpa f32 picks {picked}: fwd {sdpa[0]:.4f} ms, bwd {sdpa[1]:.4f} ms; "
          f"EFFICIENT_ATTENTION forced: fwd {eff_f:.4f} ms, bwd {eff_b:.4f} ms")


def check_attention(dev, gen, name, fwd, bwd, cases, f32_o_tol, wide=(), iters=10):
    """One attention route's forward (`fwd`, K1 or K3f) and backward
    (`bwd`, K2 or K3b) at each (B, N, H, D, dtype) of `cases`, each timed
    over runs of `iters` calls: O and LSE against the plain version (O in
    f32 to `f32_o_tol`); the gradients against the plain version in bf16
    and against a float64 version in f32, where the plain version's own
    f32 sums over wide heads and long rows stray past the bound (K2_F32_TOL);
    in f32 the kernel's O and gradients must also lie no farther from the
    float64 version than the plain version's. Returns the JSON fields of
    both for cases[0]; then, for each (rule, case) of `wide` (a kernel
    pair for wide heads: `rule(dtype, d)` says whether a case runs it,
    `case` is one of `cases`), those of that pair: the case's times and
    the largest error over the cases that run it. f32 bounds are split
    TF32's (3 x operations at PEAK_TF32)."""
    res = [{"max_abs_err": 0.0}, {"max_abs_err": 0.0}]
    wide_res = [[{"max_abs_err": 0.0}, {"max_abs_err": 0.0}] for _ in wide]
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
            oracle = want
        else:
            tol_o = f32_o_tol * max(1.0, float(o_ref.abs().max()))
            tol_l = K1_F32_TOL * max(1.0, float(lse_ref.abs().max()))
            tol_b = K2_F32_TOL if d <= 256 else K3_F32_WIDE_TOL
            f64 = (*_attn_fwd_f64(q, k, v, scale), *_attn_bwd_f64(q, k, v, o, lse, do, scale))
            oracle = f64[2:]
        errs = [_max_err(g_, w_) for g_, w_ in zip(got, oracle)]
        bounds = [tol_b * float(w_.float().abs().max()) for w_ in oracle]
        ms_f = _sync_ms(lambda: fwd(q, k, v, scale), iters)
        ms_b = _sync_ms(lambda: bwd(q, k, v, o, lse, do, scale), iters)
        plain_f = _sync_ms(lambda: denseattn.dense_attention_fwd_plain(q, k, v, scale), 3, 1)
        plain_b = _sync_ms(
            lambda: denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale), 3, 1)
        lib_f, lib_b, lib_fb = _sdpa_ms(q, k, v, do, scale)
        closer = True
        if dtype == torch.float32:
            kernel, plain = (o, lse, *got), (o_ref, lse_ref, *want)
            _print_f32_attention(name, (b, n, h, d), q, k, v, do, scale, f64, kernel, plain,
                                 (ms_f, ms_b), (lib_f, lib_b))
            # O and the gradients (LSE ~ 30-40 lands on a few ulps either way)
            closer = all(_max_err(x, y) <= _max_err(z, y)
                         for j, (x, z, y) in enumerate(zip(kernel, plain, f64)) if j != 1)
        es = q.element_size()
        elems = b * n * h * d
        # f32: three TF32 products a product (split TF32)
        mul, peak = (1, None) if dtype == torch.bfloat16 else (3, PEAK_TF32)
        bound_f = _bound(mul * 4.0 * b * h * n * n * d, 4 * es * elems + 4 * b * h * n, dtype,
                         peak)
        bound_b = _bound(mul * 10.0 * b * h * n * n * d, 8 * es * elems + 4 * b * h * n, dtype,
                         peak)
        tag = f"{name} B={b} N={n} H={h} D={d} {str(dtype)[6:]}"
        against = "the plain version" if dtype == torch.bfloat16 else "float64"
        # the cluster kernels' dQ and the f32 kernels' read the dK/dV
        # kernel's dS^T, and the bf16 kernels above 2048 and the f32 ones
        # from 192 write P^T and dS^T out: S and dP once
        once = (denseattn.wgmma_cluster(dtype, d) or denseattn.wgmma_scores(dtype, d)
                or denseattn.tf32_wide(dtype, d) or denseattn.tf32_narrow(dtype, d))
        executed = 10.0 if once else 14.0
        print(f"{tag} fwd: max|dO| {err_o:.3e} (bound {tol_o:.3e}) max|dLSE| {err_l:.3e} "
              f"(bound {tol_l:.3e}); repeat bitwise equal {repeat_f}; kernel {ms_f:.4f} ms "
              f"({4.0 * b * h * n * n * d / ms_f / 1e9:.1f} TFLOP/s), plain {plain_f:.4f} ms, "
              f"bound {bound_f['bound_ms']:.4f} ms ({bound_f['bound_by']}), "
              f"sdpa {lib_f:.4f} ms")
        print(f"{tag} bwd: max|d dq,dk,dv| from {against} "
              + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
              + ("" if oracle is want else "; from the plain version "
                 + ", ".join(f"{_max_err(g_, w_):.3e}" for g_, w_ in zip(got, want)))
              + f"; repeat bitwise equal {repeat}; kernel {ms_b:.4f} ms "
              f"({10.0 * b * h * n * n * d / ms_b / 1e9:.1f} TFLOP/s at 10 B H N^2 D, "
              f"{executed * b * h * n * n * d / ms_b / 1e9:.1f} at the {executed:.0f} B H N^2 D "
              f"executed), "
              f"plain {plain_b:.4f} ms, bound {bound_b['bound_ms']:.4f} ms "
              f"({bound_b['bound_by']}), sdpa backward {lib_b:.4f} ms, sdpa forward + "
              f"backward {lib_fb:.4f} ms (contiguous [B, H, N, D] copies)")
        if not (err_o <= tol_o and err_l <= tol_l):
            raise AssertionError(f"{name} forward disagrees with its plain version: {tag}")
        if not all(e <= t for e, t in zip(errs, bounds)):
            raise AssertionError(f"{name} backward disagrees with {against}: {tag}")
        if not closer:
            raise AssertionError(f"{name} lies farther from float64 than its plain version: {tag}")
        if not repeat_f:
            raise AssertionError(f"{name} forward differs from run to run: {tag}")
        if not repeat:
            raise AssertionError(f"{name} backward differs from run to run: {tag}")
        picks = [(res, i == 0)]
        picks += [(pair, (b, n, h, d, dtype) == case)
                  for pair, (rule, case) in zip(wide_res, wide) if rule(dtype, d)]
        for (res_f, res_b), timed in picks:
            res_f["max_abs_err"] = max(res_f["max_abs_err"], err_o, err_l)
            res_b["max_abs_err"] = max(res_b["max_abs_err"], *errs)
            if timed:
                res_f.update(ms=ms_f, plain_ms=plain_f, library_ms=lib_f, **bound_f)
                res_b.update(ms=ms_b, plain_ms=plain_b, library_ms=lib_b, **bound_b)
    return (*res, *(x for pair in wide_res for x in pair))


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


def _ffn_inputs(m, d, f, dtype, gen, dev, mixed=False):
    """x, dy, w1 [F, D], b1, w2 [D, F], b2 on the grid K6_*_TOL explains:
    every value a small integer times a power of two; with `mixed` dy, w2
    and b2 at full f32 mantissa instead."""
    grid = lambda shape, sd, step: (
        torch.randn(shape, generator=gen, device=dev) * sd / step).round().clamp(-64, 64) * step
    full = lambda shape, sd, step: torch.randn(shape, generator=gen, device=dev) * sd
    other = full if mixed else grid
    x, dy = grid((m, d), 1.0, 1 / 8), other((m, d), 1.0, 1 / 8)
    w1, w2 = grid((f, d), d ** -0.5, 1 / 256), other((d, f), f ** -0.5, 1 / 256)
    b1, b2 = grid((f,), 0.05, 1 / 2048), other((d,), 0.05, 1 / 2048)
    return [t.to(dtype) for t in (x, dy, w1, b1, w2, b2)]


def _ffn_f64(x, dy, w1, b1, w2, b2):
    """The fused FFN's y and five gradients (dx, dw1, db1, dw2, db2) in
    float64, the port's layout."""
    x, dy, w1, b1, w2, b2 = (t.double() for t in (x, dy, w1, b1, w2, b2))
    h = torch.relu(x @ w1.t() + b1)
    dh = (dy @ w2) * (h > 0)
    return (h @ w2.t() + b2 + x, dh @ w1 + dy, dh.t() @ x, dh.sum(0), dy.t() @ h, dy.sum(0))


def check_ffn(dev, gen):
    """The fused FFN forward (K6f) and backward (K6b) at each case of
    K6_CASES against their plain versions, and in f32 at each case of
    K6_F32_CASES against a float64 version (and no farther from it than
    the plain version), with the unfused Dense -> ReLU -> Dense
    composition timed beside them as a reference (there is no one PyTorch
    call for the fused function: library_ms is null). f32 bounds are split
    TF32's (3 x operations at PEAK_TF32), the FMA bound printed beside.
    Returns the JSON fields of K6_CASES[0] and of K6_F32_PATH_CASE (f32
    max_abs_err: the largest over the f32 cases)."""
    res_f, res_b = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    f32_f, f32_b = {"max_abs_err": 0.0}, {"max_abs_err": 0.0}
    cases = [(c, False) for c in K6_CASES] + [((*c, torch.float32), True) for c in K6_F32_CASES]
    for i, ((m, d, f, dtype), mixed) in enumerate(cases):
        x, dy, w1, b1, w2, b2 = _ffn_inputs(m, d, f, dtype, gen, dev, mixed)
        y = ffn.fused_ffn_fwd(x, w1, b1, w2, b2)
        got = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
        torch.cuda.synchronize()
        y_ref = ffn.fused_ffn_plain(x, w1, b1, w2, b2)
        want = ffn.fused_ffn_bwd_plain(x, dy, w1, b1, w2)
        tol = K6_BF16_TOL if dtype == torch.bfloat16 else K6_F32_TOL
        tag = f"fused_ffn M={m} D={d} F={f} {str(dtype)[6:]}" + (" mixed" if mixed else "")
        closer = True
        if mixed:
            oracle_y, *oracle = _ffn_f64(x, dy, w1, b1, w2, b2)
            kernel = [_max_err(y, oracle_y)] + [_max_err(g_, w_) for g_, w_ in zip(got, oracle)]
            plain = [_max_err(y_ref, oracle_y)] + [_max_err(p_, w_) for p_, w_ in zip(want, oracle)]
            closer = all(k <= p for k, p in zip(kernel, plain))
            print(f"{tag} vs float64: y, dx, dw1, db1, dw2, db2 kernel "
                  + ", ".join(f"{e:.3e}" for e in kernel) + ", plain "
                  + ", ".join(f"{e:.3e}" for e in plain) + " (max| | "
                  + ", ".join(f"{float(t.abs().max()):.3f}" for t in (oracle_y, *oracle)) + ")")
        else:
            oracle_y, oracle = y_ref, want
        err_y, tol_y = _max_err(y, oracle_y), tol * float(oracle_y.float().abs().max())
        errs = [_max_err(g_, w_) for g_, w_ in zip(got, oracle)]
        bounds = [tol * float(w_.float().abs().max()) for w_ in oracle]
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
        ops_f, ops_b = 4.0 * m * d * f, 10.0 * m * d * f
        # f32: three TF32 products a product (split TF32)
        mul, peak = (1, None) if dtype == torch.bfloat16 else (3, PEAK_TF32)
        bound_f = _bound(mul * ops_f, es * 2 * m * d + wbytes, dtype, peak)
        bound_b = _bound(mul * ops_b, es * 3 * m * d + 2 * wbytes, dtype, peak)
        fma = ("" if dtype == torch.bfloat16 else
               f" (split TF32; FMA bound {ops_f / PEAK_F32 * 1e3:.4f} ms)")
        fma_b = ("" if dtype == torch.bfloat16 else
                 f" (split TF32; FMA bound {ops_b / PEAK_F32 * 1e3:.4f} ms)")
        against = "float64" if mixed else "the plain version"
        print(f"{tag} fwd: max|dy| from {against} {err_y:.3e} (bound {tol_y:.3e}); kernel "
              f"{ms_f:.4f} ms ({ops_f / ms_f / 1e9:.1f} TFLOP/s), plain {plain_f:.4f} ms, bound "
              f"{bound_f['bound_ms']:.4f} ms ({bound_f['bound_by']}){fma}; unfused "
              f"Dense-ReLU-Dense reference {ref_f:.4f} ms, cuBLASLt bias+ReLU epilogue "
              f"reference {epi_f:.4f} ms")
        print(f"{tag} bwd: max|d dx,dw1,db1,dw2,db2| from {against} "
              + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
              + f"; kernel {ms_b:.4f} ms ({ops_b / ms_b / 1e9:.1f} TFLOP/s), plain "
              f"{plain_b:.4f} ms, bound {bound_b['bound_ms']:.4f} ms ({bound_b['bound_by']})"
              f"{fma_b}; unfused reference forward + backward {ref_fb:.4f} ms; K6f + K6b "
              f"{ms_f + ms_b:.4f} ms")
        if not err_y <= tol_y:
            raise AssertionError(f"fused_ffn forward disagrees with {against}: {tag}")
        if not all(e <= t for e, t in zip(errs, bounds)):
            raise AssertionError(f"fused_ffn backward disagrees with {against}: {tag}")
        if not closer:
            raise AssertionError(f"fused_ffn lies farther from float64 than its plain version: "
                                 f"{tag}")
        if not torch.equal(ffn.fused_ffn_fwd(x, w1, b1, w2, b2), y):
            raise AssertionError(f"fused_ffn forward differs from run to run: {tag}")
        again = ffn.fused_ffn_bwd(x, dy, w1, b1, w2)
        if not all(torch.equal(a, g_) for a, g_ in zip(again, got)):
            raise AssertionError(f"fused_ffn backward differs from run to run: {tag}")
        print(f"{tag}: forward and backward repeat bitwise equal True")
        picks = [(res_f, res_b, i == 0)]
        if dtype == torch.float32:
            picks.append((f32_f, f32_b, mixed and (m, d, f) == K6_F32_PATH_CASE))
        for out_f, out_b, timed in picks:
            out_f["max_abs_err"] = max(out_f["max_abs_err"], err_y)
            out_b["max_abs_err"] = max(out_b["max_abs_err"], *errs)
            if timed:
                out_f.update(ms=ms_f, plain_ms=plain_f, library_ms=None, **bound_f)
                out_b.update(ms=ms_b, plain_ms=plain_b, library_ms=None, **bound_b)
        del x, dy, w1, b1, w2, b2, y, got, y_ref, want, leaves, oracle_y, oracle
    return res_f, res_b, f32_f, f32_b


_ARMS = None


def _arms_module():
    """scripts/ab_attn_arms.py of this checkout, loaded once: the attention
    A/B arms, their library's build, plain versions and checks."""
    global _ARMS
    if _ARMS is None:
        spec = importlib.util.spec_from_file_location(
            "ab_attn_arms", os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts",
                                         "ab_attn_arms.py"))
        _ARMS = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(_ARMS)
    return _ARMS


def phase_attention_arms(dev, gen, build):
    """Phase 3b (the module docstring): `build` is the arms library's
    build handle from before phase 2. Returns the kernels line's rows of
    the arm families."""
    arms = _arms_module()
    t0 = time.perf_counter()
    arms.library(build)
    print(f"arms build: {time.perf_counter() - t0:.2f} s more, waited for at phase 3b -> "
          f"{arms.library_path().name}")
    for line in arms.ptxas_lines():
        print("  ptxas:", line)
    smoke = sys.modules[__name__]
    res = {b: arms.check_arms(smoke, dev, gen, b) for b in (BATCH, 1)}
    arms.reset_launches()
    arms.drive_path(smoke, dev)
    counts = {"bwd": dict(arms.bwd_launches), "fwd": dict(arms.fwd_launches)}
    print(f"the arms' launches in the SetVAE step: {counts}")
    idle = [f"{part} {arm}" for part, c in counts.items() for arm, n in c.items() if n <= 0]
    if idle:
        raise AssertionError(f"arms not launched in the SetVAE step: {idle}")

    def max_err(part, members):   # None where no output was compared
        errs = [r[(part, m)]["max_abs_err"] for r in res.values() for m in members]
        errs = [e for e in errs if e is not None]
        return max(errs) if errs else None

    rows = []
    for name, replaces, part, members in arms.FAMILIES:
        first = res[BATCH][(part, members[0])]
        rows.append(dict(
            name=name, route="cuda", source="scripts/ab_attn_arms.cu", replaces=replaces,
            launches=sum(counts[part][m] for m in members),
            max_abs_err=max_err(part, members),
            **{key: first[key] for key in ("ms", "plain_ms", "bound_ms", "bound_by",
                                           "library_ms")},
            package_ms=res[BATCH][(part, "full")]["ms"],
            arms={m: {"ms": res[BATCH][(part, m)]["ms"], "b1_ms": res[1][(part, m)]["ms"],
                      "plain_ms": res[BATCH][(part, m)]["plain_ms"],
                      "bound_ms": res[BATCH][(part, m)]["bound_ms"],
                      "max_abs_err": max_err(part, (m,)),
                      "launches": counts[part][m]} for m in members}))
    return rows


# the launch counter of every kernel, by the name the JSON line gives it
COUNTERS = {
    "dense_attn_fwd": denseattn.dense_attention_fwd,
    "dense_attn_bwd": denseattn.dense_attention_bwd,
    "dense_attn_bhnd_fwd": denseattn.dense_attention_bhnd,
    "dense_attn_bhnd_bwd": denseattn.dense_attention_bwd_bhnd,
    # f32 heads of 64 and 128 and of 192 and wider, and bf16 heads of 192
    # and 256, of 320 to 512, of 576 to 2048 and wider, also counted on
    # their route's wrapper
    "dense_attn_tf32_narrow_fwd": denseattn.tf32_narrow_fwd,
    "dense_attn_tf32_narrow_bwd": denseattn.tf32_narrow_bwd,
    "dense_attn_tf32_wide_fwd": denseattn.tf32_wide_fwd,
    "dense_attn_tf32_wide_bwd": denseattn.tf32_wide_bwd,
    "dense_attn_wgmma_wide_fwd": denseattn.wgmma_wide_fwd,
    "dense_attn_wgmma_wide_bwd": denseattn.wgmma_wide_bwd,
    "dense_attn_wgmma_wider_fwd": denseattn.wgmma_wider_fwd,
    "dense_attn_wgmma_wider_bwd": denseattn.wgmma_wider_bwd,
    "dense_attn_wgmma_cluster_fwd": denseattn.wgmma_cluster_fwd,
    "dense_attn_wgmma_cluster_bwd": denseattn.wgmma_cluster_bwd,
    "dense_attn_wgmma_scores_fwd": denseattn.wgmma_scores_fwd,
    "dense_attn_wgmma_scores_bwd": denseattn.wgmma_scores_bwd,
    "chamfer_nn_packed": chamfer.chamfer_nn_packed,
    "chamfer_bwd": chamfer.chamfer_bwd,
    "ffn_fwd": ffn.fused_ffn_fwd,
    "ffn_bwd": ffn.fused_ffn_bwd,
    # the f32 (split-TF32) FFN kernels, also counted on ffn_fwd / ffn_bwd
    "ffn_tf32_fwd": ffn.tf32_fwd,
    "ffn_tf32_bwd": ffn.tf32_bwd,
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
# the packed route in f32: K1 and K2 on the f32 kernels for heads of 64 and
# 128
F32_PACKED_PATH = ("dense_attn_fwd", "dense_attn_bwd", "dense_attn_tf32_narrow_fwd",
                   "dense_attn_tf32_narrow_bwd", "chamfer_nn_packed", "chamfer_bwd")


def phase_train(dev):
    """The main path: train_and_test, then the train step's ms/step.
    Returns the main path's launches, the f32 step's ms/step and its
    launches."""
    _reset_launches()
    _train_and_test(MODEL_PARAMS, TRAIN_EPOCHS, dev)
    launches = _read_launches()
    _expect_launches(launches, "the training path", PACKED_PATH,
                     [k for k in COUNTERS if k not in PACKED_PATH])
    _time_train_step("setvae", MODEL_PARAMS, BATCH, dev)
    _time_train_step("setlrvae", dict(MODEL_PARAMS, **SETLRVAE_PARAMS), SETLRVAE_BATCH, dev)
    # the f32 path (`mixed_precision: false`): every self-attention on the
    # split-TF32 K1 and K2 for heads of 64
    _reset_launches()
    f32_ms = _time_train_step("setvae", dict(MODEL_PARAMS, mixed_precision=False), BATCH, dev,
                              "f32")
    f32_launches = _read_launches()
    _expect_wide_path(f32_launches, "the f32 SetVAE train step", F32_PACKED_PATH)
    return launches, f32_ms, f32_launches


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


TF32_WIDE_PATH = ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd", "dense_attn_tf32_wide_fwd",
                  "dense_attn_tf32_wide_bwd", "chamfer_nn_packed", "chamfer_bwd")


def phase_heads1_f32(dev):
    """SetVAE with num_heads 1 under mixed_precision: false (one head of
    256, f32): the BHND route's f32 kernels for heads of 192 and wider."""
    params = dict(MODEL_PARAMS, **HEADS1_F32_OVERRIDE)
    tag = f"f32 num_heads {params['num_heads']}"
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    _expect_wide_path(launches, "the f32 num_heads 1 path", TF32_WIDE_PATH)
    return launches


def _expect_wide_path(launches, path, ran):
    """Raise unless every kernel of `ran` launched, no other did, and
    every launch of the route's wrappers (ran[0:2]) was one of the
    kernels ran[2:4] (the f32 or the wide kernels)."""
    _expect_launches(launches, path, ran, _others(ran))
    if (launches[ran[2]], launches[ran[3]]) != (launches[ran[0]], launches[ran[1]]):
        raise AssertionError(f"{path} ran other {ran[0]} / {ran[1]} kernels: {launches}")


WGMMA_WIDE_PATH = ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd", "dense_attn_wgmma_wide_fwd",
                   "dense_attn_wgmma_wide_bwd", "chamfer_nn_packed", "chamfer_bwd")


def phase_heads1_bf16(dev):
    """SetVAE with num_heads 1 (one bf16 head of 256): the BHND route's
    wgmma kernels for heads of 192 and 256."""
    params = dict(MODEL_PARAMS, **HEADS1_BF16_OVERRIDE)
    tag = f"bf16 num_heads {params['num_heads']}"
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    _expect_wide_path(launches, "the bf16 num_heads 1 path", WGMMA_WIDE_PATH)
    return launches


WGMMA_WIDER_PATH = ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd", "dense_attn_wgmma_wider_fwd",
                    "dense_attn_wgmma_wider_bwd", "chamfer_nn_packed", "chamfer_bwd")


def phase_heads1_wider(dev):
    """SetVAE with d_model 512 and num_heads 1 (one bf16 head of 512): the
    BHND route's wgmma kernels for heads of 320 to 512."""
    params = dict(MODEL_PARAMS, **HEADS1_WIDER_OVERRIDE)
    tag = f"bf16 d_model {params['d_model']} num_heads {params['num_heads']}"
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    _expect_wide_path(launches, "the bf16 d_model 512 num_heads 1 path", WGMMA_WIDER_PATH)
    return launches


WGMMA_CLUSTER_PATH = ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd",
                      "dense_attn_wgmma_cluster_fwd", "dense_attn_wgmma_cluster_bwd",
                      "chamfer_nn_packed", "chamfer_bwd")


def phase_heads1_cluster(dev):
    """SetVAE with d_model 768 and num_heads 1 (one bf16 head of 768): the
    BHND route's cluster kernels for heads of 576 to 2048."""
    params = dict(MODEL_PARAMS, **HEADS1_CLUSTER_OVERRIDE)
    tag = f"bf16 d_model {params['d_model']} num_heads {params['num_heads']}"
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    _expect_wide_path(launches, "the bf16 d_model 768 num_heads 1 path", WGMMA_CLUSTER_PATH)
    return launches


WGMMA_SCORES_PATH = ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd",
                     "dense_attn_wgmma_scores_fwd", "dense_attn_wgmma_scores_bwd",
                     "chamfer_nn_packed", "chamfer_bwd")


def phase_heads1_scores(dev):
    """SetVAE with d_model 2304 and num_heads 1 (one bf16 head of 2304):
    the BHND route's kernels over written-out scores for heads wider than
    2048; then the peak device memory of the phase's steps."""
    params = dict(MODEL_PARAMS, **HEADS1_SCORES_OVERRIDE)
    tag = f"bf16 d_model {params['d_model']} num_heads {params['num_heads']}"
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    _train_and_test(params, 1, dev)
    _time_eval_step("setvae", params, BATCH, dev, tag)
    _time_train_step("setvae", params, BATCH, dev, tag)
    launches = _read_launches()
    print(f"{tag}: peak device memory of the phase "
          f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB (B={BATCH})")
    _expect_wide_path(launches, "the bf16 d_model 2304 num_heads 1 path", WGMMA_SCORES_PATH)
    return launches


def check_cluster_fit(dev):
    """How many clusters of each cluster kernel the card holds at once, at
    one head width for each cluster size (3, 4 and 8 CTAs); raises if a
    kernel does not fit one cluster."""
    for d in (576, 1024, 2048):
        fit = denseattn.cluster_fit(d, dev)
        print(f"cluster kernels D={d}: clusters of {denseattn.cluster_ctas(d)} CTAs on panels "
              f"{denseattn.cluster_panels(d)}; cudaOccupancyMaxActiveClusters fwd {fit['fwd']}, "
              f"dK/dV {fit['dkdv']} (1 CTA an SM: "
              f"{min(fit.values()) * denseattn.cluster_ctas(d)} of "
              f"{torch.cuda.get_device_properties(dev).multi_processor_count} SMs at the least)")
        if min(fit.values()) < 1:
            raise AssertionError(f"a cluster kernel does not fit the card at D={d}: {fit}")


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
                     ("dense_attn_bhnd_fwd", "dense_attn_bhnd_bwd", "ffn_tf32_fwd",
                      "ffn_tf32_bwd"))
    return launches


FUSED_FFN_F32_PATH = F32_PACKED_PATH + ("ffn_fwd", "ffn_bwd", "ffn_tf32_fwd", "ffn_tf32_bwd")


def phase_fused_ffn_f32(dev, unfused_ms):
    """The shipped SetVAE config under mixed_precision: false with
    VST_FUSED_FFN=1 (phase 4c (8)): one fake-data epoch of train_and_test,
    the train step's ms/step beside the same call's f32 step without the
    fused FFN (`unfused_ms`, phase 4b), and the eval step's ms/batch;
    every FFN launch on the split-TF32 kernels."""
    params = dict(MODEL_PARAMS, mixed_precision=False)
    tag = "f32 " + " ".join(f"{k}={v}" for k, v in FUSED_FFN_ENV.items())
    with mock.patch.dict(os.environ, FUSED_FFN_ENV):
        _reset_launches()
        _train_and_test(params, 1, dev)
        ms = _time_train_step("setvae", params, BATCH, dev, tag)
        _time_eval_step("setvae", params, BATCH, dev, tag)
        launches = _read_launches()
    print(f"f32 SetVAE B={BATCH} train step: with the fused FFN {ms:.3f} ms/step, without it "
          f"(phase 4b, same call) {unfused_ms:.3f} ms/step")
    _expect_wide_path(launches, "the f32 VST_FUSED_FFN=1 path", FUSED_FFN_F32_PATH)
    if (launches["ffn_tf32_fwd"], launches["ffn_tf32_bwd"]) != (launches["ffn_fwd"],
                                                                launches["ffn_bwd"]):
        raise AssertionError(f"the f32 VST_FUSED_FFN=1 path ran other FFN kernels: {launches}")
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


def _reference(dev, name, params, precisions=(False, True)):
    """Card (kernels) vs CPU (plain versions) on the same weights, 2
    clouds, in f32 and bf16 (`precisions`: the mixed_precision values)."""
    n, latent = params["num_points"], params["latent_channel"]
    x, _ = fake_point_clouds(2, n, seed=SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    eps = rng.standard_normal((2, latent)).astype(np.float32)
    z = rng.standard_normal((2, latent)).astype(np.float32)
    bounds = {False: (REF_F32_LOSS_RTOL, REF_F32_RECON_ATOL),
              True: (REF_BF16_LOSS_RTOL, REF_BF16_RECON_ATOL)}
    for mixed in precisions:
        loss_rtol, recon_atol = bounds[mixed]
        mp = dict(params, mixed_precision=mixed)
        before = _read_launches()
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
        # the kernels the card side launched (eval step, forward, decode, one
        # train step): the only launches of the f32 kernels of paths no
        # timed phase runs (K3f and K3b at two f32 heads of 128)
        ran = {k: v - before[k] for k, v in _read_launches().items() if v != before[k]}
        print(f"reference {tag} launches: {ran}")


def phase_reference(dev):
    """The reference check for the shipped SetVAE config and for the
    configurations of phase 4c."""
    _reference(dev, "shipped", MODEL_PARAMS)
    _reference(dev, "num_heads 2", dict(MODEL_PARAMS, **HEADS2_OVERRIDE))
    # num_heads 1 (one head of 256) in both precisions, each on its own
    # kernels for wide heads (_reference sets mixed_precision)
    launches = (denseattn.tf32_wide_bwd.launches, denseattn.wgmma_wide_bwd.launches)
    _reference(dev, "num_heads 1", dict(MODEL_PARAMS, **HEADS1_BF16_OVERRIDE))
    if denseattn.tf32_wide_bwd.launches == launches[0]:
        raise AssertionError("the f32 num_heads 1 reference did not run the wide f32 kernels")
    if denseattn.wgmma_wide_bwd.launches == launches[1]:
        raise AssertionError("the bf16 num_heads 1 reference did not run the wide bf16 kernels")
    # d_model 512 with one head, bf16 (its path's precision): the kernels
    # for heads of 320 to 512
    launches = denseattn.wgmma_wider_bwd.launches
    _reference(dev, "d_model 512 num_heads 1", dict(MODEL_PARAMS, **HEADS1_WIDER_OVERRIDE),
               precisions=(True,))
    if denseattn.wgmma_wider_bwd.launches == launches:
        raise AssertionError("the bf16 d_model 512 num_heads 1 reference did not run the "
                             "kernels for heads of 320 to 512")
    # d_model 768 with one head, bf16: the cluster kernels
    launches = denseattn.wgmma_cluster_bwd.launches
    _reference(dev, "d_model 768 num_heads 1", dict(MODEL_PARAMS, **HEADS1_CLUSTER_OVERRIDE),
               precisions=(True,))
    if denseattn.wgmma_cluster_bwd.launches == launches:
        raise AssertionError("the bf16 d_model 768 num_heads 1 reference did not run the "
                             "cluster kernels for heads of 576 to 2048")
    # d_model 2304 with one head, bf16: the kernels over written-out scores
    launches = denseattn.wgmma_scores_bwd.launches
    _reference(dev, "d_model 2304 num_heads 1", dict(MODEL_PARAMS, **HEADS1_SCORES_OVERRIDE),
               precisions=(True,))
    if denseattn.wgmma_scores_bwd.launches == launches:
        raise AssertionError("the bf16 d_model 2304 num_heads 1 reference did not run the "
                             "kernels over written-out scores for heads wider than 2048")
    with mock.patch.dict(os.environ, FUSED_FFN_ENV):
        launches = (ffn.fused_ffn_fwd.launches, ffn.tf32_bwd.launches)
        _reference(dev, "VST_FUSED_FFN=1", MODEL_PARAMS)
        if ffn.fused_ffn_fwd.launches == launches[0]:
            raise AssertionError("the VST_FUSED_FFN=1 reference did not run the fused FFN")
        if ffn.tf32_bwd.launches == launches[1]:
            raise AssertionError("the f32 VST_FUSED_FFN=1 reference did not run the split-TF32 "
                                 "FFN kernels")


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


# Phase 12: the shipped SetVAE config with one override each (held to the
# file by tests/test_torch_isolation.py).
MOE_OVERRIDE = {"moe_experts": 4}
REMAT_OVERRIDE = {"remat": True}
SURFACE_STEPS = 5
# MoE card against CPU: 8 clouds of 256 points (the packed kernels' gates
# take them), the reference phase's bounds. The router's bf16 logits and
# softmax round at other points on the two sides, and a probability one
# ulp apart can move a near-tie to another expert: at least 99% of the
# tokens must take the same expert slot on both.
MOE_REF_POINTS = 256
MOE_ROUTED_ALIKE = 0.99
# remat against no remat from the same weights on the card: the forward is
# the same computation (the decoder's first self-attention at full batch
# instead of once at batch 1), so the loss terms agree to f32 roundoff;
# the gradients differ where the batch-summed cotangent of that layer
# rounds to bf16 once instead of per cloud (CPU, small: 1.6e-3 relative
# L2; tests/test_torch_remat.py): the reference phase's bf16 bound.
REMAT_LOSS_RTOL = 1e-6
# int8 decode against the float decode: the JAX package's bound
# (tests/test_quant.py)
INT8_REL_TOL = 0.05
COMPLEXITY_ARGS = ["--epochs", "1", "--fake_data"]


def _surface_steps(params, dev, tag, steps=SURFACE_STEPS, dropout=False, batch=BATCH):
    """SetVAE train steps at `params` on the card from the seeded weights:
    two warm-ups, then `steps` timed ones (host clock, each ending in a
    scalar fetch). Returns (ms of each timed step, peak device memory in
    GiB over all of them, launches, steps taken)."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    _reset_launches()
    model = _build("setvae", params).to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    masks = torch.Generator(device=dev).manual_seed(SEED) if dropout else None
    xs, eps = _clouds_and_noise(steps + 2, batch, params, dev, SEED + 9)
    times, terms = [], []
    for i in range(steps + 2):
        t0 = time.perf_counter()
        terms.append({k: float(v) for k, v in step(xs[i], eps[i], 0.5, masks).items()})
        times.append((time.perf_counter() - t0) * 1e3)
    times = times[2:]
    launches = _read_launches()
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    if not all(math.isfinite(v) for t in terms for v in t.values()):
        raise AssertionError(f"train step ({tag}): non-finite loss terms {terms}")
    print(f"train step setvae B={batch} N={params['num_points']} {tag}: "
          f"{statistics.median(times):.3f} ms/step median, min {min(times):.3f}, max "
          f"{max(times):.3f} over {steps} steps (host clock, each ends in a scalar fetch); "
          f"peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated); "
          f"launches {launches}")
    return times, peak, launches, steps + 2


def _per_step(params):
    """K1, K2, K4, K5 launches of one SetVAE train step without remat: one
    attention forward and backward a transformer layer's self-attention
    (the cross-attention to the one latent token needs no kernel), one
    Chamfer forward and backward."""
    layers = params["num_encoder_layers"] + params["num_decoder_layers"]
    return {"dense_attn_fwd": layers, "dense_attn_bwd": layers, "chamfer_nn_packed": 1,
            "chamfer_bwd": 1}


def _expect_counts(launches, path, want, steps):
    """Each kernel of `want` launched exactly want[k] * steps times, every
    other kernel never."""
    got = {k: v for k, v in launches.items() if v}
    expected = {k: v * steps for k, v in want.items()}
    print(f"{path}: launches {got}, counted {expected} ({steps} steps)")
    if got != expected:
        raise AssertionError(f"{path}: launches {got}, not the counted {expected}")


def _moe_routing_alike(dev, params):
    """Share of tokens the card and the CPU route to the same expert slot,
    bf16, one MoE FFN of the config on 8 clouds of 256 random points'
    worth of tokens."""
    gen = torch.Generator().manual_seed(SEED + 10)
    moe = _build("setvae", params).encoder.layers[0].moe_ffn
    x = torch.randn(REF_CLOUDS * MOE_REF_POINTS, params["d_model"], generator=gen)
    slots = []
    for where in ("cpu", dev):
        p = moe.to(where).params()
        c = ep._capacity(x.shape[0], params["moe_experts"], params.get("moe_capacity_factor", 1.25))
        with torch.no_grad():
            _, slot, keep = ep._dispatch_combine(x.to(where, torch.bfloat16),
                                                 p.router.to(torch.bfloat16),
                                                 params["moe_experts"], c)
        slots.append(torch.where(keep, slot, -1).cpu())
    return float((slots[0] == slots[1]).float().mean())


def _phase_moe(dev):
    params = dict(MODEL_PARAMS, **MOE_OVERRIDE)
    tag = "bf16 moe_experts 4"
    _, _, launches, steps = _surface_steps(params, dev, tag)
    _expect_counts(launches, f"the {tag} train steps", _per_step(params), steps)
    ref = dict(params, num_points=MOE_REF_POINTS)
    x, _ = fake_point_clouds(REF_CLOUDS, MOE_REF_POINTS, seed=SEED + 2)
    eps = np.random.default_rng(SEED + 3).standard_normal(
        (REF_CLOUDS, ref["latent_channel"])).astype(np.float32)
    for mixed, bounds in ((False, (REF_F32_LOSS_RTOL, REF_F32_GRAD_RTOL, REF_F32_MOVED_SHARE)),
                          (True, (REF_BF16_LOSS_RTOL, REF_BF16_GRAD_RTOL, REF_BF16_MOVED_SHARE))):
        _compare_train_step(dev, f"moe_experts 4 N={MOE_REF_POINTS} "
                            f"{'bf16' if mixed else 'f32'}", x, eps,
                            dict(ref, mixed_precision=mixed), *bounds)
    alike = _moe_routing_alike(dev, ref)
    print(f"MoE router, bf16, card against CPU: {alike:.6f} of {REF_CLOUDS * MOE_REF_POINTS} "
          f"tokens in the same expert slot (bound {MOE_ROUTED_ALIKE})")
    if alike < MOE_ROUTED_ALIKE:
        raise AssertionError("the MoE router routes card and CPU tokens apart")
    return launches


def _phase_remat(dev):
    params = dict(MODEL_PARAMS, **REMAT_OVERRIDE)
    plain_times, plain_peak, plain, steps = _surface_steps(MODEL_PARAMS, dev, "bf16")
    times, peak, launches, _ = _surface_steps(params, dev, "bf16 remat")
    _expect_counts(plain, "the bf16 train steps", _per_step(MODEL_PARAMS), steps)
    per_step = dict(_per_step(params))
    per_step["dense_attn_fwd"] *= 2          # each self-attention again in its recompute
    _expect_counts(launches, "the bf16 remat train steps", per_step, steps)
    print(f"remat: {statistics.median(times):.3f} against {statistics.median(plain_times):.3f} "
          f"ms/step, peak {peak:.2f} against {plain_peak:.2f} GiB; K1 "
          f"{launches['dense_attn_fwd']} against {plain['dense_attn_fwd']} launches, "
          f"{launches['dense_attn_fwd'] - plain['dense_attn_fwd']} more in {steps} steps")
    x, _ = fake_point_clouds(BATCH, NPTS, seed=SEED + 11)
    eps = np.random.default_rng(SEED + 11).standard_normal(
        (BATCH, params["latent_channel"])).astype(np.float32)
    t_off, g_off, _, _ = _train_step_once(dev, "setvae", MODEL_PARAMS, x, eps)
    t_on, g_on, _, _ = _train_step_once(dev, "setvae", params, x, eps)
    rel = max(abs(t_on[k] - t_off[k]) / max(abs(t_off[k]), 1e-12) for k in t_off)
    keys = [k for k, g in g_off.items() if g is not None and not k.endswith("key.bias")]
    gap = math.sqrt(sum(float(((g_on[k] - g_off[k]) ** 2).sum()) for k in keys)
                    / sum(float((g_off[k] ** 2).sum()) for k in keys))
    print(f"remat against no remat, one step from the same weights: loss terms max rel diff "
          f"{rel:.3e} (bound {REMAT_LOSS_RTOL}), gradient rel L2 diff {gap:.3e} (bound "
          f"{REF_BF16_GRAD_RTOL}); {t_on} and {t_off}")
    if ({k for k, g in g_on.items() if g is None} != {k for k, g in g_off.items() if g is None}
            or rel > REMAT_LOSS_RTOL or gap > REF_BF16_GRAD_RTOL):
        raise AssertionError("remat changes the train step")
    for batch in DROPOUT_BATCHES:
        try:
            _, drop_peak, _, _ = _surface_steps(dict(params, **DROPOUT_OVERRIDE), dev,
                                                "bf16 remat attn_dropout 0.1",
                                                steps=DROPOUT_STEPS, dropout=True, batch=batch)
        except torch.cuda.OutOfMemoryError as e:
            print(f"remat dropout train step at B={batch} does not fit the card: {str(e)[:200]}")
            continue
        print(f"remat with attn_dropout 0.1 at B={batch}: peak {drop_peak:.2f} GiB "
              f"(phase 7's run without remat prints its own peak above)")
        break
    else:
        raise AssertionError(f"the remat dropout step fits at none of B = {DROPOUT_BATCHES}")
    return launches


def _phase_int8(dev):
    model = _build("setvae", MODEL_PARAMS).to(dev)
    n = GEN_BATCHES * BATCH
    rates, clouds = {}, {}
    for mode in ("none", "int8"):
        generate_samples(model, BATCH, BATCH, seed=SEED, quant=mode)     # warm-up
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        clouds[mode] = generate_samples(model, n, BATCH, seed=SEED + 1, quant=mode)
        rates[mode] = n / (time.perf_counter() - t0)
    launches = _read_launches()      # the int8 decode's
    rel = float(np.abs(clouds["int8"] - clouds["none"]).max() / np.abs(clouds["none"]).max())
    table = quant.quantize_dense_params(model)
    covered, total = quant.quantized_coverage(table, model)
    # the decodes alone, the int8 copy built once
    z = torch.randn(GEN_BATCHES, BATCH, MODEL_PARAMS["latent_channel"],
                    generator=torch.Generator().manual_seed(SEED + 13)).to(dev)
    decodes = {"none": make_apply_fns(model)[1],
               "int8": quant.make_quantized_decode(model, table)}
    alone = {}
    for mode in ("none", "int8", "int8", "none"):
        decodes[mode](z[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for zb in z:
            decodes[mode](zb)
        torch.cuda.synchronize()
        alone.setdefault(mode, []).append(n / (time.perf_counter() - t0))
    print(f"int8 decode of the shipped SetVAE: {rates['int8']:.1f} clouds/s against "
          f"{rates['none']:.1f} float (generate_samples, {n} clouds in batches of {BATCH}, to "
          f"the host, the table and the int8 copy built in each call); the decodes alone, on "
          f"the card, alternating: int8 {alone['int8'][0]:.1f}, {alone['int8'][1]:.1f}, float "
          f"{alone['none'][0]:.1f}, {alone['none'][1]:.1f} clouds/s; max|int8 - float| / "
          f"max|float| {rel:.3e} (bound {INT8_REL_TOL}); {len(table)} layers, {covered} of "
          f"{total} kernel elements in int8")
    if not (np.isfinite(clouds["int8"]).all() and rel < INT8_REL_TOL):
        raise AssertionError("the int8 decode disagrees with the float decode")
    # the decode's int32 products, card against CPU: the FFN's up projection
    # (1024 of its 131072 rows), the memory token's value projection (M = 64)
    # and the output layer (F = 3, padded to 8 for torch._int_mm)
    gen = torch.Generator().manual_seed(SEED + 12)
    for name, rows in (("decoder/TransformerDecoderLayer_1/ff_up/Dense_0", 1024),
                       ("decoder/TransformerDecoderLayer_1/cross_attn/value", BATCH),
                       ("decoder/Dense_1/Dense_0", 8)):
        w8 = table[name]["w8"]
        x8 = torch.randint(-127, 128, (rows, w8.shape[0]), generator=gen, dtype=torch.int8)
        got = quant.int8_matmul(x8.to(dev), w8).cpu()
        want = quant.int8_matmul(x8, w8.cpu())
        print(f"int8 product {name} [{rows}, {w8.shape[0]}] x {list(w8.shape)}: card against "
              f"CPU bitwise equal {torch.equal(got, want)}")
        if not torch.equal(got, want):
            raise AssertionError(f"torch._int_mm and the CPU's int32 product differ ({name})")
    _expect_counts(launches, "the int8 decode",
                   {"dense_attn_fwd": MODEL_PARAMS["num_decoder_layers"]}, GEN_BATCHES)
    return launches


def _phase_complexity_profile(dev):
    _reset_launches()
    with tempfile.TemporaryDirectory() as root:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rows = complexity_cli.main(["--output_dir", os.path.join(root, "complexity"),
                                    *COMPLEXITY_ARGS])
        wall = time.perf_counter() - t0
        for r in rows:
            print(f"complexity {r}")
        print(f"complexity CLI {' '.join(COMPLEXITY_ARGS)}: {wall:.2f} s")
        if [r["model"] for r in rows] != ["VanillaVAE", "LIDVAE", "LRVAE"] or not all(
                math.isfinite(r["train_time_sec"]) and r["train_gpu_memory_mb"] > 0
                for r in rows):
            raise AssertionError(f"the complexity CLI's rows: {rows}")
        prof = os.path.join(root, "prof")
        t0 = time.perf_counter()
        train_and_test(_build("setvae", MODEL_PARAMS), epochs=TRAIN_EPOCHS, batch_size=BATCH,
                       dataset_name=COMMON_PARAMS["exp_data"], seed=SEED, lr=LR, device=dev,
                       dataset_params=dict(COMMON_PARAMS["dataset_params"], fake=True),
                       output_root=os.path.join(root, "run"), profile_dir=prof,
                       visualize_artifacts=False, progress=False)
        wall = time.perf_counter() - t0
        traces = [os.path.join(prof, f) for f in os.listdir(prof) if f.endswith(".pt.trace.json")]
        if len(traces) != 1:
            raise AssertionError(f"profile_dir holds {os.listdir(prof)}")
        with open(traces[0]) as f:
            events = json.load(f)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        attn = sum("attn" in e.get("name", "") for e in kernels)
        print(f"train_and_test with profile_dir, {TRAIN_EPOCHS} epochs at B={BATCH}: {wall:.2f} s; "
              f"{os.path.basename(traces[0])} {os.path.getsize(traces[0]) / 2**20:.1f} MiB, "
              f"{len(kernels)} kernel events, {attn} of the attention kernels")
        if not kernels or not attn:
            raise AssertionError("the profile_dir trace holds no kernel of the card")
    launches = _read_launches()
    ran = PACKED_PATH
    _expect_launches(launches, "the complexity CLI and the profiled run", ran, _others(ran))


def phase_surface(dev):
    """MoE, remat, int8 decoding, the complexity CLI and profile_dir on the
    card; returns the launches of the MoE, remat and int8 paths."""
    paths = {"moe": _phase_moe(dev), "remat": _phase_remat(dev), "int8_decode": _phase_int8(dev)}
    _phase_complexity_profile(dev)
    return paths


# Phase 13: each strategy's step on one rank against the single-device step
# from the same weights, clouds and noise on the card. On one rank every
# collective is the identity, so the arithmetic is the single-device
# step's, apart from where DTensor's ops (the 1 x 1 TP plan) and DDP's
# bucket copies cut or order it. Bounds: loss terms 1e-5 relative (f32
# loss sums); gradients 1e-3 relative L2 over the tensors (bf16 GEMM
# outputs, the reference phase's bf16 bound is 0.05); updated parameters:
# share of elements moved apart by more than lr/10 at most 1e-3 (Adam's
# first update is lr * sign(g): a ~0 gradient of the other sign moves an
# element 2 lr); BatchNorm statistics REF_BN_TOL. The trainer's FSDP run
# resumed single-device from its ckpt_0.pkl: eval loss within 1e-3
# relative, parameters within the second epoch's update budget, 4 lr.
PARALLEL_BOUNDS = {"loss": 1e-5, "grad": 1e-3, "moved": 1e-3}
PARALLEL_PATH = ("dense_attn_fwd", "dense_attn_bwd", "chamfer_nn_packed", "chamfer_bwd")
STRATEGIES = ("dp", "fsdp", "tp", "tp_fsdp")


def _full(t):
    return full_tensor(t).detach().float().cpu()


def _strategy_step(kind, model, dev):
    """(train step, model's TrainState) of strategy `kind` on a one-rank
    mesh, the model on the card."""
    from vae_song_tpu_torch.train.state import TrainState

    state = TrainState(model, make_optimizer(model.parameters(), lr=LR))
    if kind == "dp":
        mesh = mesh_lib.make_mesh()
        mesh_lib.replicate_state(state, mesh)
        return mesh_lib.make_dp_train_step(model, state.optimizer, mesh), state
    if kind == "fsdp":
        mesh = fsdp_lib.make_fsdp_mesh(1)
        state = fsdp_lib.shard_state(state, mesh)
        return fsdp_lib.make_fsdp_train_step(model, state.optimizer, mesh,
                                             state.fsdp_params), state
    mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
    if kind == "tp":
        state = tp_lib.shard_state(state, mesh)
        return tp_lib.make_tp_dp_train_step(model, state.optimizer, mesh), state
    state = fsdp_lib.shard_state_tp_fsdp(state, mesh)
    return fsdp_lib.make_tp_fsdp_train_step(model, state.optimizer, mesh,
                                            state.fsdp_params), state


def _one_step(step, model, x, eps):
    terms = {k: float(v) for k, v in step(x, eps, 0.5).items()}
    grads = {k: _full(p.grad) for k, p in model.named_parameters() if p.grad is not None}
    return terms, grads, {k: _full(v) for k, v in model.state_dict().items()}


def _strategy_ms(step, xs, eps):
    """Median ms/step over TIMED_STEPS steps after two warm-ups, host clock,
    each step ending in a scalar fetch."""
    for i in range(2):
        float(step(xs[i], eps[i], 0.5)["loss"])
    times = []
    for i in range(2, TIMED_STEPS + 2):
        t0 = time.perf_counter()
        float(step(xs[i], eps[i], 0.5)["loss"])
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _strategies_of(exp_type, params, batch, dev, card):
    """Phase 13 for one config: each strategy's step against the plain one;
    returns {strategy: launches}."""
    xs, eps = _clouds_and_noise(TIMED_STEPS + 2, batch, params, dev, SEED + 13)
    plain = _build(exp_type, params).to(dev)
    plain_step = make_train_step(plain, make_optimizer(plain.parameters(), lr=LR))
    want_terms, want_grads, want_state = _one_step(plain_step, plain, xs[0], eps[0])
    plain_ms = _strategy_ms(plain_step, xs, eps)
    frozen = set(dict(plain.named_parameters())) - set(want_grads)
    keys = [k for k in want_grads if not k.endswith("key.bias")]
    params_keys = [k for k, _ in plain.named_parameters() if k in keys]
    plain_calls, plain_attention = [], attention_lib.attention_plain
    out = {}
    for kind in STRATEGIES:
        model = _build(exp_type, params).to(dev)
        step, _ = _strategy_step(kind, model, dev)
        _reset_launches()
        with mock.patch.object(attention_lib, "attention_plain",
                               lambda *a, **k: plain_calls.append(1) or plain_attention(*a, **k)):
            terms, grads, state = _one_step(step, model, xs[0], eps[0])
            launches = _read_launches()
            ms = _strategy_ms(step, xs, eps)
        rel = max(abs(terms[k] - want_terms[k]) / max(abs(want_terms[k]), 1e-12)
                  for k in ("loss", "recon", "reg", "raw_kl"))
        diff = math.sqrt(sum(float(((grads[k] - want_grads[k]) ** 2).sum()) for k in keys))
        grad_rel = diff / math.sqrt(sum(float((want_grads[k] ** 2).sum()) for k in keys))
        deltas = torch.cat([(state[k] - want_state[k]).abs().reshape(-1) for k in params_keys])
        moved = float((deltas > LR / 10).float().mean())
        unchanged = all(torch.equal(state[k], want_state[k]) for k in frozen)
        bufs = [k for k, _ in plain.named_buffers()]
        stats = max((float((state[k] - want_state[k]).abs().max())
                     / max(1.0, float(want_state[k].abs().max())) for k in bufs), default=0.0)
        print(f"{card}: {exp_type} B={batch} {kind} step {ms:.3f} ms/step vs plain step "
              f"{plain_ms:.3f} ms/step (median of {TIMED_STEPS}, host clock); against the plain "
              f"step: loss terms max rel {rel:.3e}, gradients rel L2 {grad_rel:.3e}, params "
              f"moved apart > lr/10 {moved:.3e}, max|d| {float(deltas.max()):.3e}, "
              f"{len(frozen)} params without a gradient unchanged: {unchanged}, BatchNorm "
              f"statistics {stats:.3e}; launches in one step {launches}")
        _expect_launches(launches, f"the {kind} step ({exp_type})", PARALLEL_PATH,
                         [k for k in COUNTERS if k not in PARALLEL_PATH])
        if not (rel <= PARALLEL_BOUNDS["loss"] and grad_rel <= PARALLEL_BOUNDS["grad"]
                and moved <= PARALLEL_BOUNDS["moved"] and unchanged and stats <= REF_BN_TOL):
            raise AssertionError(f"the {kind} step ({exp_type}) disagrees with the plain step")
        out[kind] = launches
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    if plain_calls:
        raise AssertionError(f"plain attention ran {len(plain_calls)} times under the wrappers")
    return out


def _fsdp_trainer(dev, card):
    """train_and_test with fsdp for TRAIN_EPOCHS epochs (checkpoint_every 1),
    then its ckpt_0.pkl resumed single-device: the same eval loss and
    parameters within the last epoch's update budget. Returns the FSDP
    run's launches."""
    dataset_params = dict(COMMON_PARAMS["dataset_params"], fake=True)
    kw = dict(epochs=TRAIN_EPOCHS, batch_size=BATCH, dataset_name=COMMON_PARAMS["exp_data"],
              resultname=COMMON_PARAMS["resultname"], seed=SEED, dataset_params=dataset_params,
              lr=LR, device=dev, checkpoint_every=1, visualize_artifacts=False, progress=False)
    with tempfile.TemporaryDirectory() as root:
        _reset_launches()
        t0 = time.perf_counter()
        state, summary = train_and_test(_build("setvae", MODEL_PARAMS), fsdp=True,
                                        output_root=os.path.join(root, "fsdp"), **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        fsdp_params = {k: _full(v) for k, v in state.model.state_dict().items()}
        ckpt = os.path.join(summary["result_dir"], "params", "ckpt_0.pkl")
        single, resumed = train_and_test(_build("setvae", MODEL_PARAMS), resume_from=ckpt,
                                         output_root=os.path.join(root, "single"), **kw)
    steps_per_epoch = state.step // TRAIN_EPOCHS
    gap = max(float((v.float().cpu() - fsdp_params[k]).abs().max())
              for k, v in single.model.state_dict().items())
    rel = abs(resumed["eval"]["loss"] - summary["eval"]["loss"]) / abs(summary["eval"]["loss"])
    print(f"{card}: train_and_test fsdp: {TRAIN_EPOCHS} epochs of {steps_per_epoch} steps at "
          f"B={BATCH} in {wall:.2f} s, eval {summary['eval']}; launches {launches}; resumed "
          f"single-device from ckpt_0.pkl: eval loss rel diff {rel:.3e} (bound 1e-3), "
          f"max|d param| {gap:.3e} (bound {2 * steps_per_epoch * LR})")
    _expect_launches(launches, "train_and_test with fsdp", PARALLEL_PATH,
                     [k for k in COUNTERS if k not in PARALLEL_PATH])
    if not (single.step == state.step and rel <= 1e-3 and gap <= 2 * steps_per_epoch * LR):
        raise AssertionError("the FSDP checkpoint resumed single-device left the FSDP run")
    return launches


def phase_parallel(dev, card):
    """Phase 13 in a one-rank NCCL group it opens and closes; returns the
    launches of each strategy's path."""
    os.environ.pop("MASTER_ADDR", None)
    os.environ.pop("MASTER_PORT", None)
    mesh_lib.init_multihost("nccl")
    try:
        paths = {}
        for exp_type, params, batch in (
                ("setvae", MODEL_PARAMS, BATCH),
                ("setlrvae", dict(MODEL_PARAMS, **SETLRVAE_PARAMS), SETLRVAE_BATCH)):
            for kind, launches in _strategies_of(exp_type, params, batch, dev, card).items():
                paths[f"{kind}_{exp_type}"] = launches
        paths["fsdp_train_and_test"] = _fsdp_trainer(dev, card)
    finally:
        torch.distributed.destroy_process_group()
    return paths


# Phase 14: sequence, pipeline and expert parallelism on one rank, each step
# against the plain step from the same weights, clouds and noise on the
# card. PP (one stage; microbatches by the trainer's rule) and EP (one
# expert a rank, moe_experts 1, against the plain step of that MoE model)
# run the plain step's kernels on the same arithmetic but for the
# pipeline's f32 output buffer and the reductions over one rank, so they
# are held to PARALLEL_BOUNDS and the line says whether they came out
# bitwise equal; their launches in one step must equal the plain step's.
# SP runs no kernel (the JAX package routes `seq_axis` attention through
# XLA): all-gather or ring attention in plain PyTorch against the plain
# step's K1/K2, and the plain Chamfer minima against K4/K5, so it is held
# at the kernel-against-plain bounds of phases 4d and 5 (loss terms
# REF_BF16_LOSS_RTOL, gradients REF_BF16_GRAD_RTOL, moved share
# REF_BF16_MOVED_SHARE), no counter may rise and plain attention must run.
# Peak device memory of each SP step; B = 32 where B = 64 does not fit.
MODEL_PARALLEL = ("sp", "sp_ring", "pp", "ep")
SP_BOUNDS = {"loss": REF_BF16_LOSS_RTOL, "grad": REF_BF16_GRAD_RTOL,
             "moved": REF_BF16_MOVED_SHARE}
SP_BATCHES = (BATCH, BATCH // 2)
EP_OVERRIDE = {"moe_experts": 1}
PHASE14_EPOCHS = 1


def _model_parallel_step(kind, model, batch):
    """(train step(x, eps, wu), state) of `kind` on a one-rank mesh."""
    from vae_song_tpu_torch.train.state import TrainState

    state = TrainState(model, make_optimizer(model.parameters(), lr=LR))
    if kind in ("sp", "sp_ring"):
        mesh = sp.make_sp_mesh(1, 1)
        mesh_lib.replicate_state(state, mesh)
        step = sp.make_sp_train_step(model, state.optimizer, mesh, kind == "sp_ring")
        return (lambda x, eps, wu: step(sp.shard_points(x, mesh), eps, wu)), state
    if kind == "pp":
        mesh = pp.make_pp_mesh(1)
        pp_setvae.shard_pp_setvae_state(state, mesh)
        n_micro = pp_setvae.default_n_micro(batch, 1)  # the trainer's rule
        return pp_setvae.make_setvae_pp_train_step(model, state.optimizer, mesh, n_micro), state
    mesh = ep.make_ep_mesh(1)
    ep.shard_setvae_ep_state(state, mesh)
    return ep.make_setvae_ep_train_step(model, state.optimizer, mesh), state


def _gaps(terms, grads, state, want):
    """(loss terms max rel, gradients rel L2, share moved apart > lr/10,
    bitwise equal) of one step against the plain step's (terms, grads,
    state)."""
    want_terms, want_grads, want_state = want
    keys = [k for k in want_grads if not k.endswith("key.bias")]
    rel = max(abs(terms[k] - want_terms[k]) / max(abs(want_terms[k]), 1e-12)
              for k in ("loss", "recon", "reg", "raw_kl"))
    diff = math.sqrt(sum(float(((grads[k] - want_grads[k]) ** 2).sum()) for k in keys))
    grad_rel = diff / math.sqrt(sum(float((want_grads[k] ** 2).sum()) for k in keys))
    deltas = torch.cat([(state[k] - want_state[k]).abs().reshape(-1) for k in keys])
    moved = float((deltas > LR / 10).float().mean())
    bitwise = (terms == want_terms and set(grads) == set(want_grads)
               and all(torch.equal(grads[k], want_grads[k]) for k in want_grads)
               and all(torch.equal(state[k], want_state[k]) for k in want_state))
    return rel, grad_rel, moved, bitwise


def _model_parallel_of(exp_type, params, batch, dev, card):
    """Phase 14 for one config; returns {strategy: launches}."""
    plains = {}
    for tag, p in (("plain", params), ("moe", dict(params, **EP_OVERRIDE))):
        model = _build(exp_type, p).to(dev)
        step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
        xs, eps = _clouds_and_noise(TIMED_STEPS + 2, batch, params, dev, SEED + 14)
        _reset_launches()
        want = _one_step(step, model, xs[0], eps[0])
        plains[tag] = (want, _read_launches(), _strategy_ms(step, xs, eps))
        del model, step
    out = {}
    for kind in MODEL_PARALLEL:
        want, want_launches, plain_ms = plains["moe" if kind == "ep" else "plain"]
        b = batch
        for b in (SP_BATCHES if kind.startswith("sp") and batch == BATCH else (batch,)):
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            model = _build(exp_type, dict(params, **EP_OVERRIDE) if kind == "ep" else params)
            model = model.to(dev)
            step, _ = _model_parallel_step(kind, model, b)
            xs, eps = _clouds_and_noise(TIMED_STEPS + 2, batch, params, dev, SEED + 14)
            xs, eps = xs[:, :b], eps[:, :b]
            plain_calls, plain_attention = [], attention_lib.attention_plain
            _reset_launches()
            try:
                with mock.patch.object(attention_lib, "attention_plain", lambda *a, **k: (
                        plain_calls.append(1) or plain_attention(*a, **k))):
                    terms, grads, state = _one_step(step, model, xs[0], eps[0])
                    launches = _read_launches()
                    ms = _strategy_ms(step, xs, eps)
            except torch.cuda.OutOfMemoryError as e:
                print(f"{card}: {exp_type} {kind} step at B={b} does not fit the card: "
                      f"{str(e)[:200]}")
                del model, step
                continue
            peak = torch.cuda.max_memory_allocated(dev) / 2**30
            break
        else:
            raise AssertionError(f"the {kind} step ({exp_type}) fits at none of B = {SP_BATCHES}")
        if b != batch:
            # the plain step at the batch that fitted, from the same weights
            model_p = _build(exp_type, params).to(dev)
            step_p = make_train_step(model_p, make_optimizer(model_p.parameters(), lr=LR))
            _reset_launches()
            want = _one_step(step_p, model_p, xs[0], eps[0])
            want_launches, plain_ms = _read_launches(), _strategy_ms(step_p, xs, eps)
            del model_p, step_p
        rel, grad_rel, moved, bitwise = _gaps(terms, grads, state, want)
        bounds = SP_BOUNDS if kind.startswith("sp") else PARALLEL_BOUNDS
        fitted = "" if b == batch else f" (B={batch} does not fit)"
        print(f"{card}: {exp_type} B={b} {kind} step {ms:.3f} ms/step vs plain step "
              f"{plain_ms:.3f} ms/step (median of {TIMED_STEPS}, host clock){fitted}; "
              f"against the plain step: loss terms max rel {rel:.3e} (bound {bounds['loss']}), "
              f"gradients rel L2 {grad_rel:.3e} (bound {bounds['grad']}), params moved apart "
              f"> lr/10 {moved:.3e} (bound {bounds['moved']}), bitwise equal {bitwise}; peak "
              f"device memory {peak:.2f} GiB; plain attention calls {len(plain_calls)}; "
              f"launches in one step {launches} (plain step {want_launches})")
        if kind.startswith("sp"):
            _expect_launches(launches, f"the {kind} step ({exp_type})", (), tuple(COUNTERS))
            if kind == "sp" and not plain_calls:
                raise AssertionError(f"the {kind} step ({exp_type}) ran no plain attention")
        else:
            _expect_launches(launches, f"the {kind} step ({exp_type})", PARALLEL_PATH,
                             [k for k in COUNTERS if k not in PARALLEL_PATH])
            if launches != want_launches or plain_calls:
                raise AssertionError(f"the {kind} step ({exp_type}) launched {launches}, the "
                                     f"plain step {want_launches}; plain attention "
                                     f"{len(plain_calls)} calls")
        if not (rel <= bounds["loss"] and grad_rel <= bounds["grad"]
                and moved <= bounds["moved"]):
            raise AssertionError(f"the {kind} step ({exp_type}) disagrees with the plain step")
        out[kind] = launches
        del model, step
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _model_parallel_trainer(dev, card):
    """train_and_test with sequence_parallel and with pipeline_parallel on
    the one rank: each branch's mesh-shape rule needs two ranks, so it is
    patched to a 1 x 1 mesh; the branch's steps, eval and sync run as they
    are. Returns {path: launches}."""
    dataset_params = dict(COMMON_PARAMS["dataset_params"], fake=True)
    kw = dict(epochs=PHASE14_EPOCHS, batch_size=BATCH, dataset_name=COMMON_PARAMS["exp_data"],
              resultname=COMMON_PARAMS["resultname"], seed=SEED, dataset_params=dataset_params,
              lr=LR, device=dev, visualize_artifacts=False, progress=False)
    out = {}
    for name, option in (("sp_train_and_test", {"sequence_parallel": 2}),
                         ("pp_train_and_test", {"pipeline_parallel": 2})):
        with tempfile.TemporaryDirectory() as root, \
                mock.patch.object(train_loop, "_mesh_shape", lambda *a, **k: (1, 1)):
            _reset_launches()
            t0 = time.perf_counter()
            state, summary = train_and_test(_build("setvae", MODEL_PARAMS), output_root=root,
                                            **kw, **option)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = _read_launches()
        print(f"{card}: train_and_test {option} on a 1 x 1 mesh: {PHASE14_EPOCHS} epoch of "
              f"{state.step} steps at B={BATCH} in {wall:.2f} s, eval {summary['eval']}; "
              f"launches {launches}")
        if not all(math.isfinite(v) for v in summary["eval"].values()):
            raise AssertionError(f"train_and_test {option}: non-finite eval {summary['eval']}")
        if "sequence_parallel" in option:
            # the SP train and eval steps run no kernel; the last-epoch
            # export and the final metrics run the plain model (K1, K4)
            _expect_launches(launches, name, (), ("dense_attn_bwd", "chamfer_bwd", "ffn_fwd",
                                                  "ffn_bwd", "dense_attn_bhnd_fwd",
                                                  "dense_attn_bhnd_bwd"))
        else:
            _expect_launches(launches, name, PARALLEL_PATH,
                             [k for k in COUNTERS if k not in PARALLEL_PATH])
        out[name] = launches
    return out


def phase_model_parallel(dev, card):
    """Phase 14 in a one-rank NCCL group it opens and closes; returns the
    launches of each path."""
    os.environ.pop("MASTER_ADDR", None)
    os.environ.pop("MASTER_PORT", None)
    mesh_lib.init_multihost("nccl")
    try:
        paths = {}
        for exp_type, params, batch in (
                ("setvae", MODEL_PARAMS, BATCH),
                ("setlrvae", dict(MODEL_PARAMS, **SETLRVAE_PARAMS), SETLRVAE_BATCH)):
            for kind, launches in _model_parallel_of(exp_type, params, batch, dev, card).items():
                paths[f"{kind}_{exp_type}"] = launches
        paths.update(_model_parallel_trainer(dev, card))
    finally:
        torch.distributed.destroy_process_group()
    return paths


def _timed(fn, *args):
    """fn(*args), then its wall time on a line of its own."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"-- {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    card = phase_environment()
    dev = torch.device("cuda", 0)
    # the arms library's nvcc jobs run beside phase 2's
    arms_build = _arms_module().start_build()
    try:
        _timed(phase_build)
    except BaseException:
        _arms_module().stop_build(arms_build)
        raise
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1, k2, k1_f32, k2_f32 = _timed(
        check_attention, dev, gen, "dense_attn (packed route)", denseattn.dense_attention_fwd,
        denseattn.dense_attention_bwd, K1_CASES, K1_F32_TOL,
        ((denseattn.tf32_narrow, K1_F32_PATH_CASE),))
    _timed(check_cluster_fit, dev)
    (k3f, k3b, k3f_f32, k3b_f32, k3f_wide, k3b_wide, k3f_wgmma, k3b_wgmma, k3f_wider, k3b_wider,
     k3f_cluster, k3b_cluster, k3f_scores, k3b_scores) = _timed(
        check_attention, dev, gen, "dense_attn (BHND route)", denseattn.dense_attention_bhnd,
        denseattn.dense_attention_bwd_bhnd, K3_CASES, K3_F32_O_TOL,
        ((denseattn.tf32_narrow, (BATCH, NPTS, 2, 128, torch.float32)),
         (denseattn.tf32_wide, TF32_WIDE_CASE), (denseattn.wgmma_wide, WGMMA_WIDE_CASE),
         (denseattn.wgmma_wider, WGMMA_WIDER_CASE),
         (denseattn.wgmma_cluster, WGMMA_CLUSTER_CASE),
         (denseattn.wgmma_scores, WGMMA_SCORES_CASE)))
    k4 = _timed(check_chamfer, dev, gen)
    k5 = _timed(check_chamfer_bwd, dev, gen)
    k6f, k6b, k6f_tf32, k6b_tf32 = _timed(check_ffn, dev, gen)
    arm_rows = _timed(phase_attention_arms, dev, gen, arms_build)
    _timed(phase_eval_generation, dev)
    b1_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    b1 = [_timed(check_attention, dev, b1_gen, name, fwd, bwd, (case,), tol,
                 ((denseattn.tf32_narrow, case),))
          for case, (name, fwd, bwd, tol) in zip(F32_B1_CASES, (
              ("dense_attn (packed route)", denseattn.dense_attention_fwd,
               denseattn.dense_attention_bwd, K1_F32_TOL),
              ("dense_attn (BHND route)", denseattn.dense_attention_bhnd,
               denseattn.dense_attention_bwd_bhnd, K3_F32_O_TOL)))]
    # the f32 kernels for heads of 64 and 128 serve both routes: their rows
    # report the packed route's f32 path case, and the largest error
    for i, mine in enumerate((k1_f32, k2_f32)):
        mine["max_abs_err"] = max([mine["max_abs_err"], (k3f_f32, k3b_f32)[i]["max_abs_err"]]
                                  + [r[2 + i]["max_abs_err"] for r in b1])
    main_path, f32_ms, f32_path = _timed(phase_train, dev)
    heads2 = _timed(phase_heads2, dev)
    heads1_f32 = _timed(phase_heads1_f32, dev)
    heads1_bf16 = _timed(phase_heads1_bf16, dev)
    heads1_wider = _timed(phase_heads1_wider, dev)
    heads1_cluster = _timed(phase_heads1_cluster, dev)
    heads1_scores = _timed(phase_heads1_scores, dev)
    fused = _timed(phase_fused_ffn, dev)
    fused_f32 = _timed(phase_fused_ffn_f32, dev, f32_ms)
    _timed(phase_routes, dev)
    _timed(phase_reference, dev)
    paths = {"deepsets": _timed(phase_deepsets, dev)}
    paths["dropout_train"], paths["dropout_eval"] = _timed(phase_dropout, dev)
    paths["trainer_options"] = _timed(phase_trainer_options, dev)
    paths.update(_timed(phase_flexible, dev))
    paths.update(_timed(phase_lipschitz, dev))
    paths["image_path"] = _timed(phase_images, dev)
    paths.update(_timed(phase_surface, dev))
    paths.update(_timed(phase_parallel, dev, card))
    paths.update(_timed(phase_model_parallel, dev, card))
    rows = (
        ("dense_attn_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:408", main_path, k1),
        ("dense_attn_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:433", main_path, k2),
        ("dense_attn_bhnd_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:124", heads2,
         k3f),
        ("dense_attn_bhnd_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:152", heads2,
         k3b),
        ("dense_attn_tf32_narrow_fwd", "dense_attn_tf32.cu", "vae_song_tpu/ops/denseattn.py:408",
         f32_path, k1_f32),
        ("dense_attn_tf32_narrow_bwd", "dense_attn_tf32.cu", "vae_song_tpu/ops/denseattn.py:433",
         f32_path, k2_f32),
        ("dense_attn_tf32_wide_fwd", "dense_attn_tf32_wide.cu",
         "vae_song_tpu/ops/denseattn.py:124", heads1_f32, k3f_wide),
        ("dense_attn_tf32_wide_bwd", "dense_attn_tf32_wide.cu",
         "vae_song_tpu/ops/denseattn.py:152", heads1_f32, k3b_wide),
        ("dense_attn_wgmma_wide_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:124",
         heads1_bf16, k3f_wgmma),
        ("dense_attn_wgmma_wide_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:152",
         heads1_bf16, k3b_wgmma),
        ("dense_attn_wgmma_wider_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:124",
         heads1_wider, k3f_wider),
        ("dense_attn_wgmma_wider_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:152",
         heads1_wider, k3b_wider),
        ("dense_attn_wgmma_cluster_fwd", "dense_attn_fwd.cu", "vae_song_tpu/ops/denseattn.py:124",
         heads1_cluster, k3f_cluster),
        ("dense_attn_wgmma_cluster_bwd", "dense_attn_bwd.cu", "vae_song_tpu/ops/denseattn.py:152",
         heads1_cluster, k3b_cluster),
        ("dense_attn_wgmma_scores_fwd", "dense_attn_scores.cu",
         "vae_song_tpu/ops/denseattn.py:124", heads1_scores, k3f_scores),
        ("dense_attn_wgmma_scores_bwd", "dense_attn_scores.cu",
         "vae_song_tpu/ops/denseattn.py:152", heads1_scores, k3b_scores),
        ("chamfer_nn_packed", "chamfer_fwd.cu", "vae_song_tpu/ops/chamfer.py:103", main_path, k4),
        ("chamfer_bwd", "chamfer_bwd.cu", "vae_song_tpu/ops/chamfer.py:161", main_path, k5),
        ("ffn_fwd", "ffn_fwd.cu", "vae_song_tpu/ops/ffn.py:86", fused, k6f),
        ("ffn_bwd", "ffn_bwd.cu", "vae_song_tpu/ops/ffn.py:104", fused, k6b),
        ("ffn_tf32_fwd", "ffn_fwd.cu", "vae_song_tpu/ops/ffn.py:86", fused_f32, k6f_tf32),
        ("ffn_tf32_bwd", "ffn_bwd.cu", "vae_song_tpu/ops/ffn.py:104", fused_f32, k6b_tf32),
    )
    kernels = [dict(name=name, route="cuda", source=f"vae_song_tpu_torch/csrc/{src}",
                    replaces=replaces, launches=launches[name], **numbers,
                    paths={path: counts[name] for path, counts in paths.items()})
               for name, src, replaces, launches, numbers in rows]
    print(json.dumps({"kernels": kernels + arm_rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
