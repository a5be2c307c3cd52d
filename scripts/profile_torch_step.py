"""Device-time breakdown of the PyTorch port's train step on one CUDA
card, at the shipped ShapeNet configs (SetVAE at B = 64, SetLRVAE at
its config's B = 16; random weights from a seed, fake clouds), then at
the further paths chip_smoke.py phase 4c drives: SetVAE with
`num_heads: 2` (the BHND attention route, K3f / K3b), and SetVAE and
SetLRVAE with VST_FUSED_FFN=1 (the fused FFN, K6f / K6b); then those of
phases 6-8: the DeepSets SetVAE (f32), SetVAE with `attn_dropout: 0.1`
(keep masks from a CUDA generator) and SetVAE under `grad_accum: 2`;
then phase 9's FlexibleVAE steps: the pinwheel config's LR-VAE
(B = 1024), the MNIST config's MLP LR-VAE (B = 256, L = 4) and the conv
VAE of bench.py:72 (B = 256, f32); then phase 10's LIDVAE steps at the
Lipschitz CLI's width and at MNIST's (B = 256, f32).

    python scripts/profile_torch_step.py            # every step
    python scripts/profile_torch_step.py flexible   # phases 9 and 10's steps only

Prints the card's name and power limit, then for each model the median
ms/step without the profiler (host clock, each step ending in a scalar
fetch) and, from torch.profiler over PROFILED steps, the kernel time per
step grouped into classes and the top kernels. Only kernel events count
(not the op ranges that enclose them). The device's idle share is given
two ways: 1 - busy / (wall time of the profiled steps), where busy is
the union of the kernel intervals; and 1 - busy / (unprofiled ms/step),
since the profiler slows the host's launches and so inflates the first
where the host holds the device back.
"""

import os
import statistics
import subprocess
import sys
import time
from unittest import mock

import torch
from torch.autograd import DeviceType

sys.path.insert(0, ".")
import chip_smoke as cs  # noqa: E402
from vae_song_tpu_torch.data.shapenet import fake_point_clouds  # noqa: E402
from vae_song_tpu_torch.models.registry import build_model  # noqa: E402
from vae_song_tpu_torch.train.state import make_optimizer  # noqa: E402
from vae_song_tpu_torch.train.steps import make_accum_train_step  # noqa: E402

PROFILED, TIMED = 4, 8
CLASSES = (
    # one kernel pair serves both attention routes: K1 / K2 on the packed
    # route, K3f / K3b on the BHND route; the backward's three passes apart
    ("K2/K3b attention backward: preprocess (delta, qc)", ("attn_bwd_preprocess",)),
    ("K2/K3b attention backward: dK/dV", ("attn_bwd_dkdv",)),
    ("K2/K3b attention backward: dQ", ("attn_bwd_dq",)),
    ("K1/K3f attention forward", ("dense_attn_fwd",)),
    ("K6b fused FFN backward", ("ffn_bwd_rows", "ffn_wgrad", "ffn_sum_parts")),
    ("K6f fused FFN forward", ("ffn_fwd",)),
    ("K4 Chamfer forward", ("chamfer_fwd",)),
    ("K5 Chamfer backward", ("chamfer_bwd",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "implicit", "dgrad", "wgrad")),
    ("GEMMs (cuBLAS)", ("gemm", "nvjet", "cutlass", "xmma", "splitK", "gemv")),
    ("LeakyReLU fwd+bwd", ("leaky_relu",)),
    ("LayerNorm fwd+bwd", ("layer_norm", "GammaBeta")),
    ("Adam (foreach)", ("multi_tensor", "foreach")),
    ("softmax fwd+bwd", ("softmax",)),
    ("random numbers (dropout masks)", ("distribution", "philox", "rand")),
    ("reductions (bias grads, sums)", ("reduce_kernel",)),
    ("dtype casts / copies", ("copy_kernel", "direct_copy")),
    ("adds", ("CUDAFunctor_add",)),
)


def classify(name):
    for label, keys in CLASSES:
        if any(k in name for k in keys):
            return label
    return "other elementwise"


def run(exp_type, params, batch, dev, tag="bf16", n_micro=1, dropout=False):
    n, latent = params["num_points"], params["latent_channel"]
    model = build_model(exp_type, "shapenet", params, beta=params["beta_list"][0],
                        alpha=params.get("alpha_list", [0.01])[0],
                        generator=torch.Generator().manual_seed(0)).to(dev)
    step = make_accum_train_step(model, make_optimizer(model.parameters(), lr=1e-2), n_micro)
    masks = torch.Generator(device=dev).manual_seed(6) if dropout else None
    total = 3 + TIMED + PROFILED
    x_all, _ = fake_point_clouds(batch * total, n, seed=4)
    xs = torch.from_numpy(x_all).to(dev).view(total, batch, n, 3)
    eps = torch.randn(total, batch, latent, generator=torch.Generator().manual_seed(5)).to(dev)
    report(f"{exp_type} B={batch} N={n} {tag}",
           lambda i: float(step(xs[i], eps[i], 0.5, masks)["loss"]))


def run_flexible(tag, kind, dataset, params, beta, alpha, batch, n_samples, dev, il=0.0):
    """A FlexibleVAE (or LIDVAE) train step, as chip_smoke.py phases 9 and
    10 time it."""
    model = cs._flex_build(kind, dataset, params, beta, alpha, il).to(dev)
    step = make_accum_train_step(model, make_optimizer(model.parameters(), lr=1e-2), 1)
    xs = torch.from_numpy(cs._flex_inputs(dataset, batch, 9, 6)).to(dev)
    eps = torch.randn(9, n_samples, batch, model.latent_channel,
                      generator=torch.Generator().manual_seed(7)).to(dev)
    report(f"{tag} B={batch} L={n_samples}",
           lambda i: float(step(xs[i % 9], eps[i % 9], 0.5)["loss"]))


def report(tag, step):
    """Time `step(i)` (one train step on batch i, ending in a scalar
    fetch) unprofiled, then profile it; print the breakdown."""
    total = 3 + TIMED + PROFILED
    for i in range(3):
        step(i)
    times = []
    for i in range(3, 3 + TIMED):
        t0 = time.perf_counter()
        step(i)
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(3 + TIMED, total):
            step(i)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    # device-side events, without the GPU ranges of user annotations
    # (Optimizer.step) that enclose kernels
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    per_class, per_name = {}, {}
    for e in kernels:
        us = e.time_range.elapsed_us()
        label = classify(e.name)
        per_class[label] = per_class.get(label, 0.0) + us
        c, t = per_name.get(e.name, (0, 0.0))
        per_name[e.name] = (c + 1, t + us)
    busy = cs._busy_us(prof)
    dev_ms = sum(per_class.values()) / 1e3 / PROFILED
    busy_ms, unprofiled = busy / 1e3 / PROFILED, statistics.median(times)
    print(f"== {tag}: {unprofiled:.3f} ms/step unprofiled "
          f"(median of {TIMED}, host clock, scalar fetch); profiled wall {wall / PROFILED:.3f} "
          f"ms/step; kernel time {dev_ms:.3f} ms/step in {len(kernels) // PROFILED} kernels; "
          f"device busy {busy_ms:.3f} ms/step, idle {100 * (1 - busy_ms * PROFILED / wall):.1f}% "
          f"of the profiled wall, {100 * (1 - busy_ms / unprofiled):.1f}% of the unprofiled step")
    for label, us in sorted(per_class.items(), key=lambda kv: -kv[1]):
        ms = us / 1e3 / PROFILED
        print(f"    {ms:9.4f} ms  {100 * ms / dev_ms:5.1f}%  {label}")
    print("  -- top kernels")
    for name, (c, us) in sorted(per_name.items(), key=lambda kv: -kv[1][1])[:25]:
        print(f"    {us / 1e3 / PROFILED:9.4f} ms  x{c // PROFILED:<4d} {name[:110]}")


def run_set_models(dev):
    lr_params = dict(cs.MODEL_PARAMS, **cs.SETLRVAE_PARAMS)
    run("setvae", cs.MODEL_PARAMS, cs.BATCH, dev)
    run("setlrvae", lr_params, cs.SETLRVAE_BATCH, dev)
    run("setvae", dict(cs.MODEL_PARAMS, **cs.HEADS2_OVERRIDE), cs.BATCH, dev,
        "bf16 num_heads 2")
    with mock.patch.dict(os.environ, cs.FUSED_FFN_ENV):
        run("setvae", cs.MODEL_PARAMS, cs.BATCH, dev, "bf16 VST_FUSED_FFN=1")
        run("setlrvae", lr_params, cs.SETLRVAE_BATCH, dev, "bf16 VST_FUSED_FFN=1")
    run("setvae", dict(cs.MODEL_PARAMS, **cs.DEEPSETS_OVERRIDE), cs.BATCH, dev, "f32 DeepSets")
    run("setvae", dict(cs.MODEL_PARAMS, **cs.DROPOUT_OVERRIDE), cs.BATCH, dev,
        "bf16 attn_dropout 0.1", dropout=True)
    accum = cs.TRAINER_OPTIONS["grad_accum"]
    run("setvae", cs.MODEL_PARAMS, cs.BATCH, dev, f"bf16 grad_accum {accum}", n_micro=accum)


def main():
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    if "flexible" not in sys.argv[1:]:
        run_set_models(dev)
    pin = cs.PINWHEEL_CONFIG["model_params"]
    run_flexible("pinwheel LR-VAE f32", "lrvae", "pinwheel", pin, pin["beta_list"][0],
                 pin["alpha_list"][0], cs.PINWHEEL_CONFIG["common_params"]["batch_size"],
                 pin["num_mc_samples"], dev)
    mnist = cs.MNIST_PARAMS
    run_flexible("MNIST-config MLP LR-VAE f32", "lrvae", "mnist", mnist, mnist["beta_list"][0],
                 mnist["alpha_list"][0], cs.MNIST_BATCH, mnist["num_mc_samples"], dev)
    run_flexible("conv VAE (bench.py:72) f32", "vae", "mnist", cs.CONV_VAE_PARAMS, 1.0, 0.0,
                 cs.CONV_VAE_BATCH, 1, dev)
    run_flexible("LIDVAE CLI width f32", "lidvae", "pinwheel", cs.LIDVAE_CLI_PARAMS, 0.1, 0.0,
                 cs.LIDVAE_BATCH, 1, dev, il=cs.LIDVAE_IL)
    run_flexible("LIDVAE MNIST width f32", "lidvae", "mnist", {}, 0.1, 0.0, cs.LIDVAE_BATCH, 1,
                 dev, il=cs.LIDVAE_IL)


if __name__ == "__main__":
    main()
