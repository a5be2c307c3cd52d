"""Loss terms with the reference's reductions (port of
vae_song_tpu/ops/losses.py).

  * recon MSE: ((x - x_hat)**2).mean(axis=0).sum() -- mean over the
    batch, SUM over the feature axes.
  * log-MSE (Rybkin sigma-VAE): 0.5 * D * (log(2*pi*mse_i + 1e-5) + 1),
    mean over the batch, where mse_i is a per-sample mean over every
    feature axis and D the number of features.
  * KL: (-0.5 * (1 + logvar - mu^2 - exp(logvar))).mean(axis=0).sum()
  * latent-recon: ((z_in - z_rec)**2).mean(axis=0).sum() -- mean over
    the leading axis (the L Monte-Carlo samples of an [L, B, D] stack),
    sum over the rest (scales with batch size, a reference quirk kept on
    purpose).
  * pairwise_reg: LRVAE's batch-statistics KL mixed 50/50, with the
    reference's [L, L, D] broadcast.
"""

import math

import torch

from vae_song_tpu_torch.nn import sync


def mse_recon(x, recon):
    """Mean over batch, sum over features."""
    return ((x - recon) ** 2).mean(dim=0).sum()


def log_mse_recon(x, recon, eps: float = 1e-5):
    """0.5 * D * mean_b[log(2 * pi * mse_b + eps) + 1], D the feature
    count, mse_b the per-sample feature-mean squared error."""
    d = float(x[0].numel())
    per_sample_mse = ((x - recon) ** 2).mean(dim=tuple(range(1, x.dim())))
    return (0.5 * d * (torch.log(2.0 * math.pi * per_sample_mse + eps) + 1.0)).mean()


def recon_loss(x, recon, is_log_mse: bool = False):
    return log_mse_recon(x, recon) if is_log_mse else mse_recon(x, recon)


def kl_divergence(mu, log_var):
    """KL(q(z|x) || N(0, I)), mean over batch, sum over dims."""
    return (-0.5 * (1.0 + log_var - mu ** 2 - torch.exp(log_var))).mean(dim=0).sum()


def kl_per_sample(mu, log_var):
    """Per-sample KL, summed over the latent dims."""
    return -0.5 * torch.sum(1.0 + log_var - mu ** 2 - torch.exp(log_var), dim=-1)


def latent_recon_loss(z_input, z_recon):
    """((z_in - z_rec)**2).mean(axis=0).sum(). The batch is the second to
    last axis: of an [L, B, D] stack it is summed, which
    nn.sync.summed_over_batch scales under a sharded batch."""
    out = ((z_input - z_recon) ** 2).mean(dim=0).sum()
    return sync.summed_over_batch(out) if z_input.dim() > 2 else out


def pairwise_reg(loss_reg, z_input):
    """loss_reg / 2 + the batch-statistics KL / 2, broadcast as the
    reference does: with z [L, B, D], mu_zp = z.mean(1, keepdim) is
    [L, 1, D] and logvar_zp = log(((z - mu_zp)**2).mean(1)) is [L, D], so
    the KL expression broadcasts to [L, L, D]; then .mean(1).sum()."""
    mu_zp = sync.mean_over_batch(z_input.mean(dim=1, keepdim=True))
    logvar_zp = torch.log(sync.mean_over_batch(((z_input - mu_zp) ** 2).mean(dim=1)))
    term = -0.5 * (1.0 + logvar_zp - mu_zp ** 2 - torch.exp(logvar_zp))
    return loss_reg / 2.0 + term.mean(dim=1).sum() / 2.0
