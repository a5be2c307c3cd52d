"""Loss terms with the reference's reductions (port of
vae_song_tpu/ops/losses.py, the terms the set models use).

  * KL: (-0.5 * (1 + logvar - mu^2 - exp(logvar))).mean(axis=0).sum()
  * latent-recon: ((z_in - z_rec)**2).mean(axis=0).sum() -- mean over
    the leading axis, sum over the rest (scales with batch size, a
    reference quirk kept on purpose).
"""

import torch


def kl_divergence(mu, log_var):
    """KL(q(z|x) || N(0, I)), mean over batch, sum over dims."""
    return (-0.5 * (1.0 + log_var - mu ** 2 - torch.exp(log_var))).mean(dim=0).sum()


def latent_recon_loss(z_input, z_recon):
    """((z_in - z_rec)**2).mean(axis=0).sum()."""
    return ((z_input - z_recon) ** 2).mean(dim=0).sum()
