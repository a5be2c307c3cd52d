"""Whole training runs of the Lipschitz CLI (port of
vae_song_tpu/train/scan.py, its semantics; the JAX file compiles the run
into one lax.scan program, here it is a plain loop over epochs and steps
on the model's device).

Per epoch: one permutation of the dataset cut to steps x batch, the
epoch's warmup alpha (precomputed, or sigmoid(5 - the last batch's raw
KL) under kl_adaptive), one train step a batch with the optimizer it is
given (the CLI's: Adam, no scheduler) and the composite gradient unless
asked otherwise. The metrics stay on the device until the run ends; the
result is the last epoch's means and its last batch's raw KL.
"""

import numpy as np
import torch

from vae_song_tpu_torch.ops.warmup import warmup_alpha
from vae_song_tpu_torch.train.state import TrainState
from vae_song_tpu_torch.train.steps import make_train_step


def precompute_alphas(epochs, wu_strat="linear", up_amount=None, start_epoch=0,
                      repeat_interval=10, initial_alpha=0.0):
    """[epochs] float32 warmup alphas of the strategies the host can
    precompute; None for kl_adaptive, which feeds back the KL."""
    if wu_strat == "kl_adaptive":
        return None
    alpha, out = initial_alpha, []
    for e in range(epochs):
        alpha = warmup_alpha(alpha, e, epochs, wu_strat, up_amount=up_amount,
                             start_epoch=start_epoch, repeat_interval=repeat_interval)
        out.append(alpha)
    return np.array(out, np.float32)


def draw_run(generator, n, batch_size, epochs, latent, L=1):
    """The run's random inputs from a CPU torch.Generator: (perms
    [epochs, steps * batch] int64, eps [epochs, steps, L, batch, latent])."""
    steps = n // batch_size
    perms = torch.stack([torch.randperm(n, generator=generator)[:steps * batch_size]
                         for _ in range(epochs)])
    eps = torch.randn(epochs, steps, L, batch_size, latent, generator=generator)
    return perms, eps


def make_scanned_trainer(model, optimizer, batch_size: int, epochs: int,
                         grad_mode: str | None = None, L: int = 1, kl_adaptive: bool = False):
    """fit(state, X, alphas, generator=None, perms=None, eps=None) ->
    (state, last epoch's metrics as floats).

    X: [N, ...] tensor on the model's device; alphas: [epochs] warmup
    alphas (unused, may be None, under kl_adaptive). The draws are
    `perms` [epochs, steps * batch] and `eps` [epochs, steps, L, batch,
    latent] when given (the tests hand both packages the same), else
    `draw_run(generator)`. `optimizer` updates the model's parameters;
    state.step counts the steps."""
    train_step = make_train_step(model, optimizer, grad_mode or "composite")

    def fit(state: TrainState, X, alphas, generator=None, perms=None, eps=None):
        n = X.shape[0]
        steps = n // batch_size
        if steps == 0:
            raise ValueError(f"a dataset of {n} is smaller than one batch of {batch_size}")
        if perms is None:
            perms, eps = draw_run(generator, n, batch_size, epochs, model.latent_channel, L)
        dev = X.device
        last_kl = torch.zeros((), device=dev)
        for e in range(epochs):
            # kl_adaptive keys off the LAST batch's raw KL (model.py:614)
            wu_alpha = torch.sigmoid(5.0 - last_kl) if kl_adaptive else float(alphas[e])
            idx = perms[e].to(dev).reshape(steps, batch_size)
            eps_e = eps[e].to(dev)
            ms = [train_step(X[idx[s]], eps_e[s], wu_alpha) for s in range(steps)]
            state.step += steps
            last_kl = ms[-1]["raw_kl"]
        last = {k: float(torch.stack([m[k] for m in ms]).mean()) for k in ms[0]}
        last["last_raw_kl"] = float(last_kl)
        return state, last

    return fit
