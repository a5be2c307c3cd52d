"""Smoke run of the PyTorch port (vae_song_tpu_torch) on one NVIDIA
Hopper card.

    python3 chip_smoke.py

Phases, in order; any failure ends the run with a traceback and a
non-zero exit code:

  1. environment: a CUDA card is required; prints its name and power
     limit (nvidia-smi) and turns TF32 off.
  2. build: compiles the kernels from vae_song_tpu_torch/csrc with nvcc.
  3. kernels: each kernel against its plain PyTorch version on the card
     at the shapes the main path gives it, with the stated bounds, and
     the median time of both: attention forward (K1) and backward (K2),
     Chamfer forward (K4) and backward (K5).
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
  5. reference: the same weights on the CPU (plain versions of the
     kernels) against the card on 2 clouds, in f32 and in bf16: the eval
     step, the decode, and one train step (loss terms, gradients and the
     updated parameters).

The kernels' JSON line reports, for each kernel, its launches on the
training path (phase 4b) and the numbers phase 3 measured. The last two
lines are that JSON line and the result line.
"""

import json
import math
import os
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.cli.generate import generate_samples
from vae_song_tpu_torch.data.shapenet import fake_point_clouds
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.ops import chamfer, denseattn
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step, make_train_step

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
BATCH = COMMON_PARAMS["batch_size"]
EVAL_BATCHES = 4
GEN_BATCHES = 4
TRAIN_EPOCHS = 2
TIMED_STEPS = 5
LR = 1e-2           # train_and_test's lr, the reference's Adam(lr=1e-2)
SEED = 0

# Bounds of kernel against plain version on the same inputs.
# bf16 attention: the kernel rounds P to bf16 against the running row
# max, the plain version against the final one, so single P entries
# differ by <= 1 bf16 ulp (2^-8 relative) and O by about one output ulp;
# bound: 2^-6 of max(1, max|O|). LSE is f32 from the same P: 1e-3 of
# max(1, max|LSE|).
K1_BF16_O_TOL = 2.0 ** -6
K1_BF16_LSE_TOL = 1e-3
# f32 attention: same math, summation order only.
K1_F32_TOL = 1e-5
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
# Attention backward, kernel against plain version on the same inputs.
# bf16: the tensor cores and the plain f32 einsum sum S and dP in other
# orders, so a rounded exp2 argument or dP can land one bf16 ulp apart;
# dq/dk/dv round to bf16 at the end (measured: one output ulp, 0.031 at
# max|d| ~ 10); bound 2^-6 of max|d|. f32: summation order only
# (measured 1.2e-5 at max|d| ~ 16); bound 1e-5 of max|d|.
K2_BF16_TOL = 2.0 ** -6
K2_F32_TOL = 1e-5
# Chamfer backward: the same f32 terms; the plain version's index_add
# adds with atomics in another order (measured 3.6e-12 at max|d| 5e-5);
# bound 1e-6 of max|d|.
K5_TOL = 1e-6


def _sync_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the current stream, CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


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
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                print("  ptxas:", line.strip())


def _attn_inputs(b, n, h, d, dtype, gen, dev):
    # q, k scaled by 2 so the softmax is peaked, as in a trained model
    mk = lambda s: (torch.randn(b, n, h * d, generator=gen, device=dev) * s).to(dtype)
    return [t.view(b, n, h, d) for t in (mk(2.0), mk(2.0), mk(1.0))]


def check_attention(dev, gen):
    h, d = MODEL_PARAMS["num_heads"], MODEL_PARAMS["d_model"] // MODEL_PARAMS["num_heads"]
    n = MODEL_PARAMS["num_points"]
    scale = 1.0 / math.sqrt(d)
    result = {"max_abs_err": 0.0}
    for b, dtype in ((BATCH, torch.bfloat16), (1, torch.bfloat16), (4, torch.float32)):
        q, k, v = _attn_inputs(b, n, h, d, dtype, gen, dev)
        o, lse = denseattn.dense_attention_fwd(q, k, v, scale)
        torch.cuda.synchronize()
        o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, scale)
        err_o, err_l = _max_err(o, o_ref), _max_err(lse, lse_ref)
        if dtype == torch.bfloat16:
            tol_o = K1_BF16_O_TOL * max(1.0, float(o_ref.float().abs().max()))
            tol_l = K1_BF16_LSE_TOL * max(1.0, float(lse_ref.abs().max()))
        else:
            tol_o = K1_F32_TOL * max(1.0, float(o_ref.abs().max()))
            tol_l = K1_F32_TOL * max(1.0, float(lse_ref.abs().max()))
        ms = _sync_ms(lambda: denseattn.dense_attention_fwd(q, k, v, scale), 10)
        plain_ms = _sync_ms(lambda: denseattn.dense_attention_fwd_plain(q, k, v, scale), 3, 1)
        flops = 4.0 * b * h * n * n * d
        print(f"dense_attn_fwd B={b} N={n} H={h} D={d} {str(dtype)[6:]}: "
              f"max|dO| {err_o:.3e} (bound {tol_o:.3e}) max|dLSE| {err_l:.3e} "
              f"(bound {tol_l:.3e}); kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), "
              f"plain {plain_ms:.4f} ms")
        if not (err_o <= tol_o and err_l <= tol_l):
            raise AssertionError(f"dense_attn_fwd disagrees with its plain version at B={b} {dtype}")
        result["max_abs_err"] = max(result["max_abs_err"], err_o, err_l)
        if b == BATCH:
            result["ms"], result["plain_ms"] = ms, plain_ms
    return result


def check_attention_bwd(dev, gen):
    h, d = MODEL_PARAMS["num_heads"], MODEL_PARAMS["d_model"] // MODEL_PARAMS["num_heads"]
    n = MODEL_PARAMS["num_points"]
    scale = 1.0 / math.sqrt(d)
    result = {"max_abs_err": 0.0}
    for b, dtype in ((BATCH, torch.bfloat16), (1, torch.bfloat16), (4, torch.float32)):
        q, k, v = _attn_inputs(b, n, h, d, dtype, gen, dev)
        o, lse = denseattn.dense_attention_fwd(q, k, v, scale)
        do = torch.randn(b, n, h, d, generator=gen, device=dev).to(dtype)
        got = denseattn.dense_attention_bwd(q, k, v, o, lse, do, scale)
        torch.cuda.synchronize()
        want = denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale)
        tol = K2_BF16_TOL if dtype == torch.bfloat16 else K2_F32_TOL
        errs, bounds = [], []
        for g_, w_ in zip(got, want):
            errs.append(_max_err(g_, w_))
            bounds.append(tol * float(w_.float().abs().max()))
        ms = _sync_ms(lambda: denseattn.dense_attention_bwd(q, k, v, o, lse, do, scale), 10)
        plain_ms = _sync_ms(
            lambda: denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, scale), 3, 1)
        flops = 10.0 * b * h * n * n * d
        print(f"dense_attn_bwd B={b} N={n} H={h} D={d} {str(dtype)[6:]}: max|d dq,dk,dv| "
              + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
              + f"; kernel {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms")
        if not all(e <= t for e, t in zip(errs, bounds)):
            raise AssertionError(f"dense_attn_bwd disagrees with its plain version at B={b} {dtype}")
        result["max_abs_err"] = max(result["max_abs_err"], *errs)
        if b == BATCH:
            result["ms"], result["plain_ms"] = ms, plain_ms
    return result


def check_chamfer_bwd(dev, gen):
    n = MODEL_PARAMS["num_points"]
    pred = torch.randn(BATCH, n, 3, generator=gen, device=dev)
    gt = torch.randn(BATCH, n, 3, generator=gen, device=dev)
    _, argp, _, argg = chamfer.chamfer_nn_packed(pred, gt)
    got = chamfer.chamfer_bwd(pred, gt, argp, argg)
    torch.cuda.synchronize()
    want = chamfer.chamfer_bwd_plain(pred, gt, argp, argg)
    errs = [_max_err(g_, w_) for g_, w_ in zip(got, want)]
    bounds = [K5_TOL * float(w_.abs().max()) for w_ in want]
    ms = _sync_ms(lambda: chamfer.chamfer_bwd(pred, gt, argp, argg), 10)
    plain_ms = _sync_ms(lambda: chamfer.chamfer_bwd_plain(pred, gt, argp, argg), 3, 1)
    print(f"chamfer_bwd B={BATCH} N={n}: max|d dpred, dgt| "
          + ", ".join(f"{e:.3e} (bound {t:.3e})" for e, t in zip(errs, bounds))
          + f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    if not all(e <= t for e, t in zip(errs, bounds)):
        raise AssertionError("chamfer_bwd disagrees with its plain version")
    return {"max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms}


def check_chamfer(dev, gen):
    n = MODEL_PARAMS["num_points"]
    pred = torch.randn(BATCH, n, 3, generator=gen, device=dev)
    gt = torch.randn(BATCH, n, 3, generator=gen, device=dev)
    got = chamfer.chamfer_nn_packed(pred, gt)
    torch.cuda.synchronize()
    want = chamfer.chamfer_nn_packed_plain(pred, gt)
    err = max(_max_err(got[0], want[0]), _max_err(got[2], want[2]))
    same_idx = torch.equal(got[1], want[1]) and torch.equal(got[3], want[3])
    same_bits = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                    for a, b in ((got[0], want[0]), (got[2], want[2])))
    ms = _sync_ms(lambda: chamfer.chamfer_nn_packed(pred, gt), 10)
    plain_ms = _sync_ms(lambda: chamfer.chamfer_nn_packed_plain(pred, gt), 3, 1)
    print(f"chamfer_nn_packed B={BATCH} N={n}: argmin equal {same_idx}, min bitwise "
          f"equal {same_bits}, max|dmin| {err:.3e} (bound {K4_TOL}); kernel {ms:.4f} ms "
          f"(2 launches), plain {plain_ms:.4f} ms")
    if not (same_idx and same_bits and err <= K4_TOL):
        raise AssertionError("chamfer_nn_packed disagrees with its plain version")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def _reset_launches():
    for fn in (denseattn.dense_attention_fwd, denseattn.dense_attention_bwd,
               chamfer.chamfer_nn_packed, chamfer.chamfer_bwd):
        fn.launches = 0


def _read_launches():
    return {
        "dense_attn_fwd": denseattn.dense_attention_fwd.launches,
        "dense_attn_bwd": denseattn.dense_attention_bwd.launches,
        "chamfer_nn_packed": chamfer.chamfer_nn_packed.launches,
        "chamfer_bwd": chamfer.chamfer_bwd.launches,
    }


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
    print(f"eval/generation launches: {launches}")
    for name in ("dense_attn_fwd", "chamfer_nn_packed"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was not launched by eval and generation")
    if launches["dense_attn_bwd"] or launches["chamfer_bwd"]:
        raise AssertionError(f"a backward kernel ran during eval/generation: {launches}")


def _time_train_step(exp_type, params, batch, dev):
    """Median ms/step of make_train_step over TIMED_STEPS steps after two
    warm-up steps, host clock, each step ending in a scalar fetch."""
    n, latent = params["num_points"], params["latent_channel"]
    model = build_model(exp_type, "shapenet", params, beta=params["beta_list"][0],
                        alpha=params.get("alpha_list", [0.01])[0],
                        generator=torch.Generator().manual_seed(SEED)).to(dev)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    gen = torch.Generator().manual_seed(SEED + 4)
    x_all, _ = fake_point_clouds(batch * (TIMED_STEPS + 2), n, seed=SEED + 4)
    xs = torch.from_numpy(x_all).to(dev).view(TIMED_STEPS + 2, batch, n, 3)
    eps = torch.randn(TIMED_STEPS + 2, batch, latent, generator=gen).to(dev)
    for i in range(2):
        float(step(xs[i], eps[i], 0.5)["loss"])
    times, losses = [], []
    for i in range(2, TIMED_STEPS + 2):
        t0 = time.perf_counter()
        losses.append(float(step(xs[i], eps[i], 0.5)["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{exp_type} train step: non-finite loss {losses}")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    print(f"train step {exp_type} B={batch} N={n} bf16: {statistics.median(times):.3f} ms/step "
          f"median, {statistics.mean(times):.3f} mean over {TIMED_STEPS} steps (host clock, "
          f"each step ends in a scalar fetch); losses {[round(v, 4) for v in losses]}; "
          f"peak device memory so far {peak:.2f} GiB")
    return statistics.median(times)


def phase_train(dev):
    """The main path: train_and_test, then the train step's ms/step."""
    model = build_model("setvae", "shapenet", MODEL_PARAMS, beta=MODEL_PARAMS["beta_list"][0],
                        generator=torch.Generator().manual_seed(SEED))
    dataset_params = dict(COMMON_PARAMS["dataset_params"], fake=True)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as root:
        _reset_launches()
        t0 = time.perf_counter()
        state, summary = train_and_test(
            model, epochs=TRAIN_EPOCHS, batch_size=BATCH, dataset_name=COMMON_PARAMS["exp_data"],
            logfilename=COMMON_PARAMS["logfilename"], resultname=COMMON_PARAMS["resultname"],
            grad_clip=COMMON_PARAMS["grad_clip"], seed=SEED, dataset_params=dataset_params,
            output_root=root, lr=LR, device=dev,
        )
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = _read_launches()
        params_dir = os.path.join(summary["result_dir"], "params")
        clouds_dir = os.path.join(summary["result_dir"], "point_clouds")
        written = (sorted(os.listdir(params_dir)), len(os.listdir(clouds_dir)),
                   sorted(os.listdir(os.path.join(root, "log"))))
    numbers = dict(summary["eval"], **summary["posterior_metrics"])
    print(f"train_and_test: {TRAIN_EPOCHS} epochs of {state.step // TRAIN_EPOCHS} steps at "
          f"B={BATCH} in {wall:.2f} s; final eval {summary['eval']}; posterior metrics "
          f"{summary['posterior_metrics']}; wrote params {written[0]}, {written[1]} point-cloud "
          f"files, log {written[2]}")
    print(f"training launches: {launches}")
    if not all(math.isfinite(v) for v in numbers.values()):
        raise AssertionError(f"non-finite train/eval numbers: {numbers}")
    if written[0] != [f"model_{TRAIN_EPOCHS - 1}.pkl"] or written[1] != 24 or not written[2]:
        raise AssertionError(f"train_and_test did not write its artifacts: {written}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the training path")
    _time_train_step("setvae", MODEL_PARAMS, BATCH, dev)
    _time_train_step("setlrvae", dict(MODEL_PARAMS, **SETLRVAE_PARAMS), SETLRVAE_BATCH, dev)
    return launches


def _train_step_once(where, params, x, eps):
    """One train step at lr LR from the seeded weights: (loss terms,
    gradients, parameters after the update), on the host."""
    model = build_model("setvae", "shapenet", params, beta=params["beta_list"][0],
                        generator=torch.Generator().manual_seed(SEED)).to(where)
    step = make_train_step(model, make_optimizer(model.parameters(), lr=LR))
    terms = {k: float(v) for k, v in step(torch.from_numpy(x).to(where),
                                          torch.from_numpy(eps).to(where)).items()}
    grads = {k: None if p.grad is None else p.grad.float().cpu()
             for k, p in model.named_parameters()}
    after = {k: p.detach().float().cpu() for k, p in model.named_parameters()}
    return terms, grads, after


def _compare_train_step(dev, tag, x, eps, params, loss_rtol, grad_rtol, moved_share):
    (t_cpu, g_cpu, p_cpu), (t_dev, g_dev, p_dev) = (
        _train_step_once(where, params, x, eps) for where in ("cpu", dev))
    initial = build_model("setvae", "shapenet", params, beta=params["beta_list"][0],
                          generator=torch.Generator().manual_seed(SEED)).state_dict()
    rel = max(abs(t_dev[k] - t_cpu[k]) / max(abs(t_cpu[k]), 1e-12)
              for k in ("loss", "recon", "reg", "raw_kl"))
    if {k for k, g in g_cpu.items() if g is None} != {k for k, g in g_dev.items() if g is None}:
        raise AssertionError(f"train step {tag}: card and CPU give gradients to other parameters")
    # a key projection's bias has an analytically zero gradient (the
    # softmax is shift-invariant along each row): what is computed is
    # roundoff on either side, so it is left out of the comparisons
    keys = [k for k, g in g_cpu.items() if g is not None and not k.endswith("key.bias")]
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
    print(f"reference train step {tag}: loss terms max rel diff {rel:.3e} (bound {loss_rtol}); "
          f"gradient rel L2 diff {grad_rel:.3e} (bound {grad_rtol}) over {len(keys)} tensors; "
          f"updated params: share moved apart by > lr/10 {share:.3e} (bound {moved_share}), "
          f"max|d| {float(deltas.max()):.3e} (not bounded); {len(frozen)} parameters without a "
          f"gradient unchanged: {unchanged}; cpu {t_cpu} card {t_dev}")
    if not (rel <= loss_rtol and grad_rel <= grad_rtol and share <= moved_share
            and unchanged and frozen):
        raise AssertionError(f"card and CPU train steps disagree ({tag})")


def phase_reference(dev):
    """Card (kernels) vs CPU (plain versions) on the same weights, 2 clouds."""
    n, latent = MODEL_PARAMS["num_points"], MODEL_PARAMS["latent_channel"]
    x, _ = fake_point_clouds(2, n, seed=SEED + 2)
    rng = np.random.default_rng(SEED + 3)
    eps = rng.standard_normal((2, latent)).astype(np.float32)
    z = rng.standard_normal((2, latent)).astype(np.float32)
    for mixed, loss_rtol, recon_atol in ((False, REF_F32_LOSS_RTOL, REF_F32_RECON_ATOL),
                                         (True, REF_BF16_LOSS_RTOL, REF_BF16_RECON_ATOL)):
        params = dict(MODEL_PARAMS, mixed_precision=mixed)
        outs = {}
        for where in ("cpu", dev):
            model = build_model("setvae", "shapenet", params, beta=params["beta_list"][0],
                                generator=torch.Generator().manual_seed(SEED)).to(where)
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
        tag = "bf16" if mixed else "f32"
        print(f"reference {tag}: loss terms max rel diff {rel:.3e} (bound {loss_rtol}), "
              f"recon max|d| {err_r:.3e}, decode max|d| {err_g:.3e} (bound {recon_atol}); "
              f"cpu {m_cpu} card {m_dev}")
        if not (rel <= loss_rtol and err_r <= recon_atol and err_g <= recon_atol):
            raise AssertionError(f"card and CPU disagree ({tag})")
        grad_rtol, moved_share = ((REF_F32_GRAD_RTOL, REF_F32_MOVED_SHARE) if not mixed
                                  else (REF_BF16_GRAD_RTOL, REF_BF16_MOVED_SHARE))
        _compare_train_step(dev, tag, x, eps, params, loss_rtol, grad_rtol, moved_share)


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
    k1 = _timed(check_attention, dev, gen)
    k2 = _timed(check_attention_bwd, dev, gen)
    k4 = _timed(check_chamfer, dev, gen)
    k5 = _timed(check_chamfer_bwd, dev, gen)
    _timed(phase_eval_generation, dev)
    launches = _timed(phase_train, dev)
    _timed(phase_reference, dev)
    kernels = [
        dict(name="dense_attn_fwd", route="cuda",
             source="vae_song_tpu_torch/csrc/dense_attn_fwd.cu",
             replaces="vae_song_tpu/ops/denseattn.py:408",
             launches=launches["dense_attn_fwd"], **k1),
        dict(name="dense_attn_bwd", route="cuda",
             source="vae_song_tpu_torch/csrc/dense_attn_bwd.cu",
             replaces="vae_song_tpu/ops/denseattn.py:433",
             launches=launches["dense_attn_bwd"], **k2),
        dict(name="chamfer_nn_packed", route="cuda",
             source="vae_song_tpu_torch/csrc/chamfer_fwd.cu",
             replaces="vae_song_tpu/ops/chamfer.py:103",
             launches=launches["chamfer_nn_packed"], **k4),
        dict(name="chamfer_bwd", route="cuda",
             source="vae_song_tpu_torch/csrc/chamfer_bwd.cu",
             replaces="vae_song_tpu/ops/chamfer.py:161",
             launches=launches["chamfer_bwd"], **k5),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
