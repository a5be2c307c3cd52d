"""Evaluation metrics: AU, KL, MI, importance-weighted NLL (port of
vae_song_tpu/ops/metrics.py; the math of the reference's utils.py:40-164).

Randomness is explicit: the functions that sample z take the standard
normal noise `eps` as a tensor, and `measure_posterior_metrics` draws it
from a `torch.Generator` on the CPU, so the numbers do not depend on the
device.
"""

import math

import torch

from vae_song_tpu_torch.ops.losses import kl_divergence


def reparameterize(mu, logvar, eps):
    """z [B, ns, nz] = mu + eps * exp(logvar / 2) for eps [B, ns, nz]
    (utils.py:40-47)."""
    return mu[:, None, :] + eps * torch.exp(0.5 * logvar)[:, None, :]


def calc_au_per_batch(z, eps: float = 0.01):
    """Fraction of latent dims whose batch variance >= eps (utils.py:49-50)."""
    var = ((z - z.mean(dim=0, keepdim=True)) ** 2).mean(dim=0)
    return (var >= eps).float().mean()


def calc_mi(mu, logvar, eps):
    """MC mutual-information estimate I(x, z) (utils.py:87-107); eps
    [B, 1, nz]."""
    x_batch, nz = mu.shape
    neg_entropy = (-0.5 * nz * math.log(2 * math.pi) - 0.5 * (1.0 + logvar).sum(-1)).mean()
    z_samples = reparameterize(mu, logvar, eps)             # [B, 1, nz]
    mu_e, logvar_e = mu[None], logvar[None]                 # [1, B, nz]
    dev = z_samples - mu_e                                  # [B, B, nz]
    log_density = -0.5 * ((dev ** 2) / torch.exp(logvar_e)).sum(-1) - 0.5 * (
        nz * math.log(2 * math.pi) + logvar_e.sum(-1)
    )                                                       # [B, B]
    log_qz = torch.logsumexp(log_density, dim=1) - math.log(x_batch)
    return neg_entropy - log_qz.mean(-1)


def eval_inference_dist(mu, logvar, z):
    """log q(z|x) for z [B, ns, nz] (utils.py:127-138)."""
    nz = z.shape[2]
    mu_e, logvar_e = mu[:, None], logvar[:, None]
    dev = z - mu_e
    return -0.5 * ((dev ** 2) / torch.exp(logvar_e)).sum(-1) - 0.5 * (
        nz * math.log(2 * math.pi) + logvar_e.sum(-1)
    )


def nll_iw(mu, log_var, loss_rec, eps):
    """Importance-weighted NLL estimate (utils.py:109-120), eps [B, ns,
    nz]. Keeps the reference's formulation: the scalar reconstruction
    loss stands in for log p(x|z), and the log-sum-exp runs over every
    (batch, sample) element."""
    nsamples = eps.shape[1]
    z = reparameterize(mu, log_var, eps)                    # [B, ns, nz]
    log_prior = (-0.5 * (z ** 2) - 0.5 * math.log(2 * math.pi)).sum(-1)
    tmp = (log_prior - loss_rec) - eval_inference_dist(mu, log_var, z)
    return -(torch.logsumexp(tmp.reshape(-1), dim=0) - math.log(nsamples))


def measure_posterior_metrics(generator, mu, log_var, loss_rec, nsamples: int = 100):
    """AU / KL / MI / NLL / total variance on one batch (utils.py:144-164),
    as 0-dim tensors. The noise is drawn from `generator` (a CPU
    torch.Generator): first the MI draw [B, 1, nz], then the NLL draw
    [B, nsamples, nz]."""
    b, nz = mu.shape
    eps_mi = torch.randn(b, 1, nz, generator=generator).to(mu.device)
    eps_nll = torch.randn(b, nsamples, nz, generator=generator).to(mu.device)
    return {
        "au": calc_au_per_batch(mu),
        "kl": kl_divergence(mu, log_var),
        "mi": calc_mi(mu, log_var, eps_mi),
        "nll": nll_iw(mu, log_var, loss_rec, eps_nll),
        "mean_var": torch.exp(log_var).sum(),
    }
