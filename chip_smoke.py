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
     the median time of both.
  4. main path: the shipped ShapeNet SetVAE config at full width
     (B = 64 clouds of N = 2048 points, bf16), random weights from a
     seed: the eval step on 4 batches after a warm-up, then generation
     of 4 batches of 64 clouds. Both kernels' launch counters must rise.
  5. reference: the same weights on the CPU (plain versions of the
     kernels) against the card on 2 clouds, in f32 and in bf16.

The last two lines are the kernels' JSON summary and the result line.
"""

import json
import math
import statistics
import subprocess
import time

import numpy as np
import torch

from vae_song_tpu_torch import _kernels
from vae_song_tpu_torch.cli.generate import generate_samples
from vae_song_tpu_torch.data.shapenet import fake_point_clouds
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.ops import chamfer, denseattn
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step

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
BATCH = 64          # common_params.batch_size of the config
EVAL_BATCHES = 4
GEN_BATCHES = 4
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


def phase_main_path(dev):
    gen = torch.Generator().manual_seed(SEED)
    model = build_model("setvae", "shapenet", MODEL_PARAMS,
                        beta=MODEL_PARAMS["beta_list"][0], generator=gen).to(dev)
    n, latent = MODEL_PARAMS["num_points"], MODEL_PARAMS["latent_channel"]
    x_all, _ = fake_point_clouds(BATCH * (EVAL_BATCHES + 1), n, seed=SEED)
    xs = torch.from_numpy(x_all).to(dev).view(EVAL_BATCHES + 1, BATCH, n, 3)
    eps = torch.randn(EVAL_BATCHES + 1, BATCH, latent, generator=gen).to(dev)
    eval_step = make_eval_step(model)
    torch.cuda.synchronize()

    denseattn.dense_attention_fwd.launches = 0
    chamfer.chamfer_nn_packed.launches = 0
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
    launches = {
        "dense_attn_fwd": denseattn.dense_attention_fwd.launches,
        "chamfer_nn_packed": chamfer.chamfer_nn_packed.launches,
    }

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
    print(f"main-path launches: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"kernel {name} was not launched on the main path")
    return launches


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


def main():
    phase_environment()
    dev = torch.device("cuda", 0)
    phase_build()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    k1 = check_attention(dev, gen)
    k4 = check_chamfer(dev, gen)
    launches = phase_main_path(dev)
    phase_reference(dev)
    kernels = [
        dict(name="dense_attn_fwd", route="cuda",
             source="vae_song_tpu_torch/csrc/dense_attn_fwd.cu",
             replaces="vae_song_tpu/ops/denseattn.py:408",
             launches=launches["dense_attn_fwd"], **k1),
        dict(name="chamfer_nn_packed", route="cuda",
             source="vae_song_tpu_torch/csrc/chamfer_fwd.cu",
             replaces="vae_song_tpu/ops/chamfer.py:103",
             launches=launches["chamfer_nn_packed"], **k4),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
