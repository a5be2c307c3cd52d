"""End-to-end train/eval loop for the set models on one device (port of
vae_song_tpu/train/loop.py:train_and_test, its single-device set-model
branch with per-batch steps, :802-1009 and :1016-1096).

Per epoch: the warmup alpha (SetLRVAE), one train step per shuffled
batch, the eval step over the test split, TensorBoard scalars and the
progress line. At the last epoch: `params/model_{epoch}.pkl` in the JAX
package's format and the `.ply`/`.npy` point-cloud dumps. At the end:
the posterior metrics on one batch of 50 test clouds, the experiment log
and the unified CSV row. The artifact tree is the JAX trainer's:

    <output_root>/results/<resultname>/<run name>/{log.txt, params/, point_clouds/}
    <output_root>/runs/<run name>/events.out.tfevents.*
    <output_root>/log/<logfilename>

Randomness: the batch order is the JAX pipeline's (a numpy Generator
seeded with [seed, epoch]); the reparameterisation noise, which JAX
draws from its own PRNG, comes from CPU torch.Generators seeded from
(seed, epoch, stream), so a run does not depend on the device. The JAX
package's multistep and scanned dispatch paths are TPU machinery and
have no counterpart; options that are not ported raise.
"""

import os
import time
from datetime import datetime

import numpy as np
import torch

from vae_song_tpu_torch import data as data_lib
from vae_song_tpu_torch.data.pipeline import iterate_batches, num_batches
from vae_song_tpu_torch.models.setvae import SetLRVAE, SetVAE
from vae_song_tpu_torch.ops import metrics as metrics_lib
from vae_song_tpu_torch.ops.warmup import warmup_alpha
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train import loggers
from vae_song_tpu_torch.train.state import TrainState, make_optimizer
from vae_song_tpu_torch.train.steps import make_apply_fns, make_eval_step, make_train_step
from vae_song_tpu_torch.viz.plots import save_point_cloud

_METRICS = ("loss", "recon", "reg", "lr")
# noise streams of one run
_TRAIN, _EVAL, _FINAL, _DUMP = range(4)


def synth_run_name(model, alpha=None) -> str:
    """Run-name synthesis (main.py:211-219)."""
    name = type(model).__name__ + datetime.now().strftime(" %m%d%H%M")
    if not type(model).__name__.startswith("NaiveAE"):
        name += "_b=" + str(float(model.beta))
    if type(model).__name__.startswith(("LR", "SetLR")):
        name += "_a=" + str(model.alpha if alpha is None else alpha)
    return name


def _generator(seed: int, *stream: int) -> torch.Generator:
    """CPU generator seeded from (seed, *stream) through numpy's
    SeedSequence."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1)[0]
    return torch.Generator().manual_seed(int(state))


def _refuse_unported(model, epochs, *, data_parallel, pipeline_parallel, expert_parallel,
                     tensor_parallel, sequence_parallel, sequence_parallel_ring, fsdp,
                     grad_accum, resume_from, checkpoint_every, async_checkpoint,
                     profile_dir, native_prefetch):
    if not isinstance(model, SetVAE):
        raise NotImplementedError(
            f"train_and_test trains the attention set models only; {type(model).__name__} "
            "is not ported yet (see ROADMAP.md Queue 1 items 9 and 12)"
        )
    parallel = {
        "data_parallel": data_parallel,
        "pipeline_parallel": (pipeline_parallel or 0) > 1,
        "expert_parallel": expert_parallel,
        "tensor_parallel": (tensor_parallel or 0) > 1,
        "sequence_parallel": (sequence_parallel or 0) > 1,
        "sequence_parallel_ring": sequence_parallel_ring,
        "fsdp": fsdp,
    }
    unported = [(k, "Queue 1 item 15 (nn/moe.py and parallel/)") for k, on in parallel.items() if on]
    if (grad_accum or 0) > 1:
        unported.append(("grad_accum", "Queue 1 item 17 (trainer options)"))
    for key, val in (("resume_from", resume_from), ("checkpoint_every", checkpoint_every),
                     ("async_checkpoint", async_checkpoint)):
        if val:
            unported.append((key, "Queue 1 item 17 (trainer options)"))
    if profile_dir is not None:
        unported.append(("profile_dir", "Queue 1 item 16 (train/profiling.py)"))
    if native_prefetch:
        unported.append(("native_prefetch", "Queue 1 item 10 (the data layer)"))
    if epochs < 0:
        unported.append(("generation-only mode (epochs < 0)",
                         "Queue 1 item 13 (FID and generation)"))
    if unported:
        key, item = unported[0]
        raise NotImplementedError(
            f"{key} is not ported to the PyTorch trainer yet; see ROADMAP.md {item}"
        )


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _means(ms: list[dict]) -> dict:
    """Per-key means of a list of metric dicts of 0-dim tensors, fetched
    to the host once per key."""
    if not ms:
        return {k: 0.0 for k in _METRICS}
    return {k: float(torch.stack([m[k] for m in ms]).float().mean()) for k in ms[0]}


def train_and_test(
    model,
    epochs: int = 100,
    batch_size: int = 128,
    dataset_name: str = "mnist",
    logfilename: str = "log.csv",
    resultname: str = "res",
    pt_param: str | None = None,
    num_mc_samples: int = 1,
    grad_clip: dict | None = None,
    wu_strat: str = "linear",
    seed: int = 42,
    dataset_params: dict | None = None,
    output_root: str = ".",
    lr: float = 1e-2,
    checkpoint_every: int | None = None,
    profile_dir: str | None = None,
    resume_from: str | None = None,
    data_parallel: bool = False,
    native_prefetch: bool = False,
    pipeline_parallel: int = 0,
    expert_parallel: bool = False,
    tensor_parallel: int = 0,
    sequence_parallel: int = 0,
    sequence_parallel_ring: bool = False,
    fsdp: bool = False,
    async_checkpoint: bool = False,
    grad_accum: int = 0,
    device="cuda",
):
    """Train `model` (a SetVAE or SetLRVAE, moved to `device`) and
    evaluate it every epoch; returns (TrainState, summary dict). The
    arguments keep the JAX function's names; the learning rate always
    follows the cosine schedule, and `num_mc_samples` is accepted and,
    as in the JAX set models, does not change the step (L = 1)."""
    del num_mc_samples
    _refuse_unported(
        model, epochs, data_parallel=data_parallel, pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel, tensor_parallel=tensor_parallel,
        sequence_parallel=sequence_parallel, sequence_parallel_ring=sequence_parallel_ring,
        fsdp=fsdp, grad_accum=grad_accum, resume_from=resume_from,
        checkpoint_every=checkpoint_every, async_checkpoint=async_checkpoint,
        profile_dir=profile_dir, native_prefetch=native_prefetch,
    )
    device = torch.device(device)
    train_ds, test_ds, _ = data_lib.load_dataset(dataset_name, **(dataset_params or {}))
    steps_per_epoch = num_batches(train_ds, batch_size)
    if steps_per_epoch == 0:
        raise ValueError("Dataset smaller than one batch")

    if pt_param is not None:
        if not os.path.exists(pt_param):
            raise FileNotFoundError(f"No such file: {pt_param}")
        ckpt_lib.load_params_only(pt_param, model)
    model.to(device)
    optimizer = make_optimizer(
        model.parameters(), lr=lr,
        total_steps=max(1, epochs * steps_per_epoch),
        grad_clip=grad_clip,
    )
    state = TrainState(model, optimizer)

    name = synth_run_name(model)
    result_dir = os.path.join(output_root, "results", resultname, name)
    os.makedirs(os.path.join(result_dir, "params"), exist_ok=True)
    writer = loggers.TensorBoardWriter(os.path.join(output_root, "runs", name))
    explog = loggers.create_experiment_logger(result_dir, name)
    explog.log_hyperparameters(
        epochs=epochs, batch_size=batch_size, device=_device_name(device),
        dataset_name=dataset_name, num_mc_samples=1, wu_strat=wu_strat, grad_clip=grad_clip,
    )
    explog.log_model_info(model)

    train_step = make_train_step(model, optimizer)
    eval_step = make_eval_step(model)
    _, decode_fn, forward_fn = make_apply_fns(model)
    latent = model.latent_channel
    has_warmup = isinstance(model, SetLRVAE)
    wu_alpha, last_kl = 0.0, 0.0
    eval_means = {k: 0.0 for k in _METRICS}
    t_start = time.time()

    for epoch in range(epochs):
        if has_warmup:
            wu_alpha = warmup_alpha(wu_alpha, epoch, epochs, wu_strat, last_kl_loss=last_kl)
            explog.log_alpha_value(epoch, wu_alpha)

        ep_np_rng = np.random.default_rng([seed, epoch])
        noise = _generator(seed, epoch, _TRAIN)
        ms = []
        for x, _y in iterate_batches(train_ds, batch_size, rng=ep_np_rng, device=device):
            eps = torch.randn(x.shape[0], latent, generator=noise).to(device)
            ms.append(train_step(x, eps, wu_alpha))
            state.step += 1
        train_means = _means(ms)
        writer.add_scalar("loss/train", train_means["loss"], epoch)
        writer.add_scalar("recon/train", train_means["recon"], epoch)
        writer.add_scalar("reg/train", train_means["reg"], epoch)
        # kl_adaptive warmup reads the LAST batch's unscaled KL (model.py:62, 614)
        last_kl = float(ms[-1]["raw_kl"]) if has_warmup else 0.0
        last_epoch = epoch == epochs - 1

        noise = _generator(seed, epoch, _EVAL)
        ev_ms = []
        for x, _y in iterate_batches(test_ds, batch_size, shuffle=False, device=device):
            eps = torch.randn(x.shape[0], latent, generator=noise).to(device)
            ev_ms.append(eval_step(x, eps, wu_alpha))
        eval_means = _means(ev_ms)
        writer.add_scalar("loss/test", eval_means["loss"], epoch)

        if epoch % max(1, epochs // 20) == 0 or last_epoch:
            print(
                f"[{name}] epoch {epoch}: train loss {train_means['loss']:.4f} "
                f"recon {train_means['recon']:.4f} reg {train_means['reg']:.4f} "
                f"| test loss {eval_means['loss']:.4f}",
                flush=True,
            )

        if last_epoch:
            ckpt_lib.save_params_only(
                os.path.join(result_dir, "params", f"model_{epoch}.pkl"), model)
            _dump_set_samples(model, test_ds, decode_fn, forward_fn, resultname, name,
                              epoch, output_root, _generator(seed, epoch, _DUMP), device)

    writer.close()

    # final metrics on one 50-sample batch (main.py:363-372)
    noise = _generator(seed, max(epochs, 0), _FINAL)
    mb = min(50, len(test_ds))
    xb = torch.from_numpy(test_ds.X[:mb]).to(device)
    eps = torch.randn(mb, latent, generator=noise).to(device)
    outs = forward_fn(xb, eps)
    with torch.inference_mode():
        _, loss_rec, _, _ = model.loss(xb, *outs, wu_alpha=wu_alpha)
        pm = metrics_lib.measure_posterior_metrics(noise, outs[1], outs[2], loss_rec)
    pm = {k: float(v) for k, v in pm.items()}

    duration = time.time() - t_start
    explog.log_evaluation_metrics(
        au=pm["au"], kl=pm["kl"], mi=pm["mi"], nll=pm["nll"], mean_var=pm["mean_var"],
        vloss=eval_means["loss"], vlrec=eval_means["recon"],
        vlreg=eval_means["reg"], vllr=eval_means["lr"],
    )
    explog.log_alpha_warmup_summary(wu_strat)
    explog.finalize_log()
    loggers.log_unified_dict(
        os.path.join(output_root, "log"),
        {
            "name": name, "dataset_name": dataset_name, "epoch": epochs, "fid": -1,
            "au": pm["au"], "kl": pm["kl"], "mi": pm["mi"], "nll": pm["nll"],
            "vloss": eval_means["loss"], "vlrec": eval_means["recon"],
            "vlreg": eval_means["reg"], "vllr": eval_means["lr"],
            "mean_var": pm["mean_var"],
        },
        logfilename=logfilename,
    )
    summary = dict(name=name, duration_sec=duration, eval=eval_means,
                   posterior_metrics=pm, result_dir=result_dir)
    return state, summary


def _dump_set_samples(model, test_ds, decode_fn, forward_fn, resultname, name, epoch, root,
                      noise, device, n_samples=4):
    """Point-cloud recon/prior .ply/.npy dumps (main.py:52-89): the first
    test clouds and their reconstructions from mu, then clouds decoded
    from z ~ N(0, I)."""
    outdir = os.path.join(root, "results", resultname, name, "point_clouds")
    os.makedirs(outdir, exist_ok=True)
    for i in range(min(n_samples, len(test_ds))):
        x = torch.from_numpy(test_ds.X[i:i + 1]).to(device)
        recon = forward_fn(x)[0]
        save_point_cloud(recon[0], os.path.join(outdir, f"{name}_epoch{epoch}_recon_{i:02d}"))
        save_point_cloud(test_ds.X[i], os.path.join(outdir, f"{name}_epoch{epoch}_orig_{i:02d}"))
    for i in range(n_samples):
        z = torch.randn(1, model.latent_channel, generator=noise).to(device)
        pts = decode_fn(z)
        save_point_cloud(pts[0], os.path.join(outdir, f"{name}_epoch{epoch}_prior_{i:02d}"))
