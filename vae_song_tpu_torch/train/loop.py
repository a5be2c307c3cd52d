"""End-to-end train/eval loop on one device for the set models, the
FlexibleVAE family and LIDVAE (port of vae_song_tpu/train/loop.py:train_and_test,
its single-device branch with per-batch steps, :802-1009 and
:1016-1096).

Per epoch: the warmup alpha (the models that set `has_warmup`: LRVAE,
SetLRVAE), one train step per shuffled batch (or, with `grad_accum`, one
optimizer update per batch from that many microbatches), the dataset's
augment applied to each training batch on the device (MNIST's rotation
and crop, CIFAR-10's and CelebA's flip), the eval step over the test split
(in the order of the pipeline, shuffled for the 1-D datasets as JAX's
dispatched loop does), TensorBoard scalars and the progress line, and with
`checkpoint_every` the full train state at `params/ckpt_{epoch}.pkl`
(optionally written by the AsyncCheckpointer's worker thread). With
`native_prefetch` the training batches come from the native loader's C++
threads (data/native.py), seeded from the epoch's numpy Generator as in
JAX. At the last epoch: `params/model_{epoch}.pkl` in the JAX package's
format, and the set models' `.ply`/`.npy` point-cloud dumps, or for the
other models, from the last eval batch, the 1-D datasets' five
`scatter2d/{epoch}_{input,mu,z,recon,sample}.png` plots or the images'
four `valontr/{epoch}_{origin,recon,recon_wos,sample}.png` grids, and the
`pca/` plots of mu and z (matplotlib is imported there; without it the run
prints which plots it did not write and goes on). At the end: the
posterior metrics on one batch of 50 test samples, the experiment log and
the unified CSV row. `resume_from` continues a run from such a checkpoint
at the next epoch. Generation-only mode (`epochs < 0`, main.py:323-360)
trains nothing: it decodes 50 batches of z ~ N(0, I) from the model (its
`pt_param` checkpoint), writes one PNG an image under `generation/`, and
scores them against the test images with the FID (ops/fid.py) on the
device, which the CSV row carries. The artifact tree is the JAX
trainer's:

    <output_root>/results/<resultname>/<run name>/{log.txt, params/, point_clouds/,
        scatter2d/, valontr/, pca/, generation/}
    <output_root>/runs/<run name>/events.out.tfevents.*
    <output_root>/log/<logfilename>

The FlexibleVAE family trains with L = num_mc_samples Monte-Carlo
latents a step and evaluates with L = 1, as JAX does; the set models
and LIDVAE (single-sample in JAX too) take one latent a step.

Randomness: the batch order is the JAX pipeline's (a numpy Generator
seeded with [seed, epoch]); the reparameterisation noise and the augment's
draws, which JAX takes from its own PRNG, come from CPU torch.Generators
seeded from (seed, epoch, stream), so they do not depend on the device.
The training-dropout masks come from a generator on the training device
seeded the same way (a [64, 4, 2048, 2048] mask a layer cannot be drawn
on the host every step), so a run with attn_dropout > 0 depends on the
device: the card's and the CPU's streams differ. Per-epoch seeding
makes a resumed run replay the continuous one. The JAX package's
multistep and scanned dispatch paths are TPU machinery and have no
counterpart; the options that are not ported (the parallel strategies,
profile_dir) raise naming their ROADMAP.md item.
"""

import os
import sys
import time
from datetime import datetime

import numpy as np
import torch

from vae_song_tpu_torch import data as data_lib
from vae_song_tpu_torch.data.pipeline import iterate_batches, num_batches
from vae_song_tpu_torch.models.flexible import FlexibleVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.models.setvae import SetVAE
from vae_song_tpu_torch.ops import fid as fid_lib
from vae_song_tpu_torch.ops import metrics as metrics_lib
from vae_song_tpu_torch.ops.warmup import warmup_alpha
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train import loggers
from vae_song_tpu_torch.train.state import TrainState, make_optimizer
from vae_song_tpu_torch.train.steps import (make_accum_train_step, make_apply_fns,
                                             make_eval_step)
from vae_song_tpu_torch.viz.pca import pca_visualization
from vae_song_tpu_torch.viz.plots import (save_image_grid, save_point_cloud,
                                          visualize_2c_points_on_image)

_METRICS = ("loss", "recon", "reg", "lr")
# random streams of one run
_TRAIN, _EVAL, _FINAL, _DUMP, _DROPOUT, _AUGMENT, _GENERATE = range(7)
# generation-only mode decodes this many batches (main.py:326)
SAMPLE_ITERATION = 50


def synth_run_name(model, alpha=None) -> str:
    """Run-name synthesis (main.py:211-219)."""
    name = type(model).__name__ + datetime.now().strftime(" %m%d%H%M")
    if not type(model).__name__.startswith("NaiveAE"):
        name += "_b=" + str(float(model.beta))
    if type(model).__name__.startswith(("LR", "SetLR")):
        name += "_a=" + str(model.alpha if alpha is None else alpha)
    if getattr(model, "is_log_mse", False):
        name += "_logmse"
    if type(model).__name__ == "LIDVAE":
        name += "_il=" + str(float(model.inverse_lipschitz) / 2.0)
    return name


def _generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    """Generator on `device` seeded from (seed, *stream) through numpy's
    SeedSequence."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _compute_fid(test_ds, generated: np.ndarray, device, chunk: int = 256) -> float:
    """FID between the first 5000 test images and the generated ones
    (main.py:349-360 analogue), the features computed on `device`:
    InceptionV3 pool3 with $VST_FID_WEIGHTS (pytorch_fid-comparable), else
    the seeded random-conv features (comparable between runs of either
    package, not to Inception-FID)."""
    real = np.asarray(test_ds.X[:5000], np.float32)
    extractor, is_inception = fid_lib.default_extractor(real.shape[1:], seed=0, device=device)

    def chunks(a):
        for i in range(0, len(a), chunk):
            yield a[i:i + chunk]

    score = fid_lib.fid_score(extractor, chunks(real), chunks(generated))
    tag = ("InceptionV3 pool3, $VST_FID_WEIGHTS — pytorch_fid-comparable"
           if is_inception else "seeded random-conv features, non-Inception")
    print(f"FID ({tag}): {score:.4f}")
    return score


def _refuse_unported(model, *, data_parallel, pipeline_parallel, expert_parallel,
                     tensor_parallel, sequence_parallel, sequence_parallel_ring, fsdp,
                     profile_dir):
    if not isinstance(model, (SetVAE, FlexibleVAE, LIDVAE)):
        raise TypeError(
            f"train_and_test trains the set models, the FlexibleVAE family and LIDVAE; "
            f"got {type(model).__name__}"
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
    if profile_dir is not None:
        unported.append(("profile_dir", "Queue 1 item 16 (train/profiling.py)"))
    if unported:
        key, item = unported[0]
        raise NotImplementedError(
            f"{key} is not ported to the PyTorch trainer yet; see ROADMAP.md {item}"
        )


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _noise(shape, generator, device) -> torch.Tensor:
    """N(0, 1) noise of `shape` drawn on the CPU from `generator`, on `device`."""
    return torch.randn(*shape, generator=generator).to(device)


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
    """Train `model` (a set model, a FlexibleVAE or LIDVAE, moved to `device`) and
    evaluate it every epoch; returns (TrainState, summary dict). The
    arguments keep the JAX function's names; the learning rate always
    follows the cosine schedule. `num_mc_samples` is the FlexibleVAE
    train step's L; as in JAX, it does not change the set models' or
    LIDVAE's step (L = 1).

    checkpoint_every: write the full train state to
    `params/ckpt_{epoch}.pkl` after every that many epochs, with the
    warmup state (`wu_alpha`, `last_kl`) as its `extra`.
    async_checkpoint: write those on the AsyncCheckpointer's worker
    thread; a failed write warns at the end instead of raising.
    resume_from: a `checkpoint_every` file; training continues at its
    epoch + 1 with its parameters, BatchNorm statistics, Adam state,
    step and warmup state, and replays the continuous run.
    grad_accum: >= 2 takes each optimizer update from that many
    sequential microbatches of the batch (`make_accum_train_step`);
    `batch_size` must divide by it.
    native_prefetch: assemble the training batches on the native loader's
    C++ threads (data/native.py:NativeBatchLoader); its shuffle is the
    library's, so the batch order differs from a run without it (as in
    JAX); without the library it takes the numpy path, as in JAX.
    epochs < 0: generation-only mode (the module's docstring); image
    datasets only, since it writes image PNGs and an image FID."""
    _refuse_unported(
        model, data_parallel=data_parallel, pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel, tensor_parallel=tensor_parallel,
        sequence_parallel=sequence_parallel, sequence_parallel_ring=sequence_parallel_ring,
        fsdp=fsdp, profile_dir=profile_dir,
    )
    if grad_accum and grad_accum > 1 and batch_size % grad_accum != 0:
        raise ValueError(
            f"batch_size={batch_size} must divide over "
            f"grad_accum={grad_accum} microbatches"
        )
    device = torch.device(device)
    train_ds, test_ds, augment = data_lib.load_dataset(dataset_name, **(dataset_params or {}))
    is_set = getattr(model, "data_type", None) == "set"
    data_type = "set" if is_set else "1d" if dataset_name in ("pinwheel", "chessboard") else "2d"
    is_image = not is_set and train_ds.X.ndim == 4
    if epochs < 0 and not is_image:
        raise ValueError(
            f"generation-only mode (epochs < 0) writes image PNGs and an image FID; "
            f"{dataset_name!r} is not an image dataset")
    n_samples = 1 if is_set or isinstance(model, LIDVAE) else num_mc_samples
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

    start_epoch, resume_extra = 0, {}
    if resume_from is not None:
        state, ckpt_epoch, resume_extra = ckpt_lib.load_checkpoint(resume_from, state)
        start_epoch = ckpt_epoch + 1

    name = synth_run_name(model)
    result_dir = os.path.join(output_root, "results", resultname, name)
    os.makedirs(os.path.join(result_dir, "params"), exist_ok=True)
    writer = loggers.TensorBoardWriter(os.path.join(output_root, "runs", name))
    explog = loggers.create_experiment_logger(result_dir, name)
    explog.log_hyperparameters(
        epochs=epochs, batch_size=batch_size, device=_device_name(device),
        dataset_name=dataset_name, num_mc_samples=n_samples, wu_strat=wu_strat,
        grad_clip=grad_clip,
    )
    explog.log_model_info(model)

    train_step = make_accum_train_step(model, optimizer, max(1, grad_accum or 1))
    eval_step = make_eval_step(model)
    encode_fn, decode_fn, forward_fn = make_apply_fns(model)
    latent = model.latent_channel

    def eps_of(b, gen, samples=n_samples):
        """Noise of one batch of b: [b, latent] for the set models,
        [samples, b, latent] for the FlexibleVAE family and LIDVAE."""
        return _noise((b, latent) if is_set else (samples, b, latent), gen, device)

    has_warmup = getattr(model, "has_warmup", False)
    wu_alpha, last_kl = 0.0, 0.0
    if has_warmup and start_epoch > 0:
        if "wu_alpha" in resume_extra:
            # the restored warmup state continues kl_adaptive exactly
            wu_alpha = float(resume_extra["wu_alpha"])
            last_kl = float(resume_extra.get("last_kl", 0.0))
        else:
            # a checkpoint without it: replay the deterministic schedules
            # (kl_adaptive degrades to alpha(kl=0)), as the JAX trainer does
            for e in range(start_epoch):
                wu_alpha = warmup_alpha(wu_alpha, e, epochs, wu_strat, last_kl_loss=last_kl)
    eval_means = {k: 0.0 for k in _METRICS}
    async_ckpt = ckpt_lib.AsyncCheckpointer() if async_checkpoint and checkpoint_every else None
    t_start = time.time()

    for epoch in range(start_epoch, epochs):
        if has_warmup:
            wu_alpha = warmup_alpha(wu_alpha, epoch, epochs, wu_strat, last_kl_loss=last_kl)
            explog.log_alpha_value(epoch, wu_alpha)

        ep_np_rng = np.random.default_rng([seed, epoch])
        noise = _generator(seed, epoch, _TRAIN)
        dropout_rng = _generator(seed, epoch, _DROPOUT, device=device) if is_set else None
        augment_rng = _generator(seed, epoch, _AUGMENT) if augment is not None else None
        ms = []
        for x, _y in iterate_batches(train_ds, batch_size, rng=ep_np_rng, device=device,
                                     augment=augment, augment_rng=augment_rng,
                                     native_prefetch=native_prefetch):
            ms.append(train_step(x, eps_of(x.shape[0], noise), wu_alpha, dropout_rng))
            state.step += 1
        train_means = _means(ms)
        writer.add_scalar("loss/train", train_means["loss"], epoch)
        writer.add_scalar("recon/train", train_means["recon"], epoch)
        writer.add_scalar("reg/train", train_means["reg"], epoch)
        # kl_adaptive warmup reads the LAST batch's unscaled KL (model.py:62, 614)
        last_kl = float(ms[-1]["raw_kl"]) if has_warmup else 0.0
        last_epoch = epoch == epochs - 1

        noise = _generator(seed, epoch, _EVAL)
        ev_ms, last_eval_batch = [], None
        for x, y in iterate_batches(test_ds, batch_size, rng=ep_np_rng,
                                    shuffle=data_type == "1d", device=device):
            ev_ms.append(eval_step(x, eps_of(x.shape[0], noise, 1), wu_alpha))
            last_eval_batch = (x, y)
        eval_means = _means(ev_ms)
        writer.add_scalar("loss/test", eval_means["loss"], epoch)

        if epoch % max(1, epochs // 20) == 0 or last_epoch:
            print(
                f"[{name}] epoch {epoch}: train loss {train_means['loss']:.4f} "
                f"recon {train_means['recon']:.4f} reg {train_means['reg']:.4f} "
                f"| test loss {eval_means['loss']:.4f}",
                flush=True,
            )

        if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            ckpt_path = os.path.join(result_dir, "params", f"ckpt_{epoch}.pkl")
            ckpt_extra = {"wu_alpha": float(wu_alpha), "last_kl": float(last_kl)}
            if async_ckpt is not None:
                async_ckpt.submit(ckpt_path, state, epoch, extra=ckpt_extra)
            else:
                ckpt_lib.save_checkpoint(ckpt_path, state, epoch, extra=ckpt_extra)

        if last_epoch:
            ckpt_lib.save_params_only(
                os.path.join(result_dir, "params", f"model_{epoch}.pkl"), model)
            dump_noise = _generator(seed, epoch, _DUMP)
            if is_set:
                _dump_set_samples(model, test_ds, decode_fn, forward_fn, resultname, name,
                                  epoch, output_root, dump_noise, device)
            elif last_eval_batch is not None:
                _dump_artifacts(model, last_eval_batch, encode_fn, decode_fn, forward_fn,
                                data_type, resultname, name, epoch, output_root, dump_noise,
                                device)

    writer.close()

    fid = -1
    if epochs < 0:
        generated = _generate_images(model, decode_fn, batch_size, result_dir, name,
                                     _generator(seed, 0, _GENERATE), device)
        fid = _compute_fid(test_ds, generated, device)

    # final metrics on one 50-sample batch (main.py:363-372)
    noise = _generator(seed, max(epochs, 0), _FINAL)
    mb = min(50, len(test_ds))
    xb = torch.from_numpy(test_ds.X[:mb]).to(device)
    outs = forward_fn(xb, eps_of(mb, noise, 1))
    with torch.no_grad():
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
            "name": name, "dataset_name": dataset_name, "epoch": epochs, "fid": fid,
            "au": pm["au"], "kl": pm["kl"], "mi": pm["mi"], "nll": pm["nll"],
            "vloss": eval_means["loss"], "vlrec": eval_means["recon"],
            "vlreg": eval_means["reg"], "vllr": eval_means["lr"],
            "mean_var": pm["mean_var"],
        },
        logfilename=logfilename,
    )
    if async_ckpt is not None:
        # join the writes in flight before handing the result dir back; a
        # failed write must not discard the trained state the caller is owed
        try:
            async_ckpt.close()
        except Exception as e:
            print(f"[{name}] WARNING: async checkpoint write failed: {e!r} "
                  "(training completed; the periodic snapshot is missing)",
                  file=sys.stderr, flush=True)

    summary = dict(name=name, duration_sec=duration, eval=eval_means,
                   posterior_metrics=pm, result_dir=result_dir, fid=fid)
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


def _dump_artifacts(model, last_batch, encode_fn, decode_fn, forward_fn, data_type,
                    resultname, name, epoch, root, noise, device):
    """The last-epoch plots of the last eval batch (main.py:110-170): for
    the 1-D datasets its points, mu, z and reconstruction (one latent
    sample each) and the decode of z ~ N(0, I), coloured by class, as
    `scatter2d/{epoch}_{input,mu,z,recon,sample}.png`; for images the grids
    `valontr/{epoch}_{origin,recon,recon_wos,sample}.png` (recon_wos decodes
    mu) of the first 256; then the PCA/t-SNE plots of mu and z under
    `pca/`. The noise is drawn from `noise` in that order: the forward's,
    the prior's, the PCA's. Non-image 2-D data gets only the PCA (JAX's
    image grid would fail on it)."""
    x, y = last_batch
    latent = model.latent_channel
    outs = forward_fn(x, _noise((1, x.shape[0], latent), noise, device))
    sample = decode_fn(_noise((x.shape[0], latent), noise, device))
    pca_eps = _noise((min(x.shape[0], 1000), latent), noise, "cpu")
    if data_type == "1d":
        z = outs[3].reshape(-1, latent)          # [1, B, latent] or LIDVAE's [B, latent]
        plots = {"input": x, "mu": outs[1], "z": z, "recon": outs[0], "sample": sample}
        try:
            for tensor_name, points in plots.items():
                visualize_2c_points_on_image(points, y, resultname, name, epoch, tensor_name,
                                             root)
        except ImportError as e:
            # visualization must never kill a training run (the JAX trainer's rule)
            print(f"[{name}] scatter2d plots {list(plots)} not written: {e!r}", flush=True)
    elif x.dim() == 4:
        outdir = os.path.join(root, "results", resultname, name, "valontr")
        grids = {"origin": x, "recon": outs[0].clamp(0, 1),
                 "recon_wos": forward_fn(x)[0].clamp(0, 1), "sample": sample.clamp(0, 1)}
        try:
            for tag, images in grids.items():
                save_image_grid(images[:256], os.path.join(outdir, f"{epoch}_{tag}.png"))
        except ImportError as e:
            print(f"[{name}] valontr grids {list(grids)} not written: {e!r}", flush=True)

    def enc(xx):
        return encode_fn(torch.from_numpy(np.ascontiguousarray(xx)).to(device))

    try:
        pca_visualization(enc, x, y, pca_eps, epoch, name, resultname, root=root)
    except Exception as e:  # visualization must never kill a training run
        print(f"[{name}] pca_visualization failed: {e!r}", flush=True)


def _generate_images(model, decode_fn, batch_size, result_dir, name, noise, device):
    """Generation-only mode: SAMPLE_ITERATION batches of z ~ N(0, I) from
    `noise`, decoded and clipped to [0, 1], one PNG an image at
    `generation/{index}.png`; returns them [N, H, W, C] as numpy. Without
    matplotlib the PNGs are skipped with one line."""
    gen_dir = os.path.join(result_dir, "generation")
    os.makedirs(gen_dir, exist_ok=True)
    out, write = [], True
    for i in range(SAMPLE_ITERATION):
        z = _noise((batch_size, model.latent_channel), noise, device)
        images = decode_fn(z).clamp(0, 1).float().cpu().numpy()
        out.append(images)
        for j in range(batch_size if write else 0):
            try:
                save_image_grid(images[j:j + 1], os.path.join(gen_dir, f"{i * batch_size + j}.png"),
                                nrow=1, normalize=True)
            except ImportError as e:
                print(f"[{name}] generation PNGs not written: {e!r}", flush=True)
                write = False
                break
    return np.concatenate(out)
