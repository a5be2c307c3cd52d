"""LID-VAE, the Lipschitz-invertible-decoder VAE (port of
vae_song_tpu/models/lidvae.py; the reference's model.py:637-886).

The decoder is two ICNN Brenier maps around an identity injection B:

    x = grad_z [ ICNN_1(z) + (il/2) ||z||^2 ]
    x = x @ B^T            (B = eye(data_dim, latent_dim): zero-pad or cut)
    y = grad_x [ ICNN_2(x) + (il/2) ||x||^2 ]

Each map is `torch.autograd.grad` of the batch-summed potential. While
autograd records (a train step), the gradient is taken with
`create_graph=True`, so the loss reaches the ICNN weights and the encoder
through it (a second-order backward). Under `torch.no_grad()` (the eval
step, the apply functions, the analysis) the map is taken inside
`torch.enable_grad()` on a detached input and returned with no graph, so
nothing outlives the call. `torch.inference_mode()` cannot host the
decode: autograd refuses to record on inference tensors.

As in the JAX package: the encoder is the MLP one (1-D data) or the conv
one (images, NHWC), softplus is applied to the second half of its output,
which is then used as the log-variance (a reference quirk kept on
purpose), and the model is single-sample: `forward` takes eps [B, latent]
(or [1, B, latent]) whatever the trainer's num_mc_samples says.
"""

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vae_song_tpu_torch.models.flexible import (ConvEncoder2D, MLPEncoder2D,
                                                 resolve_dataset_defaults,
                                                 transpose_padding_schedule)
from vae_song_tpu_torch.nn.blocks import ICNN
from vae_song_tpu_torch.ops import losses

# LIDVAE's own per-dataset defaults (model.py:660-687): celeba latent 64,
# mnist/fashionmnist latent 32, omniglot hidden (32, 64, 128).
LIDVAE_DATASET_OVERRIDES = {
    "celeba": dict(latent_channel=64),
    "mnist": dict(latent_channel=32),
    "fashionmnist": dict(latent_channel=32),
    "omniglot": dict(hidden_channels=(32, 64, 128)),
}


class LIDVAE(nn.Module):
    """`forward(x, eps)` returns (recon, mu, log_var, z, None) as the JAX
    model's __call__ does; `loss` is recon + beta * KL."""

    grad_mode = "composite"

    def __init__(self, in_channel: int = 1, latent_channel: int = 32,
                 hidden_channels: Tuple[int, ...] = (32, 64, 128),
                 icnn_channels: Tuple[int, int] = (512, 1024), input_dim: int = 28,
                 inverse_lipschitz: float = 0.0, beta: float = 1.0, is_log_mse: bool = False,
                 data_type: str = "2d", generator=None):
        super().__init__()
        if len(icnn_channels) != 2:
            raise ValueError("2-length array was expected for `icnn_channels`")
        self.in_channel, self.latent_channel = in_channel, latent_channel
        self.hidden_channels, self.icnn_channels = tuple(hidden_channels), tuple(icnn_channels)
        self.input_dim, self.inverse_lipschitz = input_dim, inverse_lipschitz
        self.beta, self.is_log_mse, self.data_type = beta, is_log_mse, data_type
        g, out2 = generator, latent_channel * 2
        if data_type == "1d":
            self.data_dim = input_dim * in_channel
            self.encoder = MLPEncoder2D(self.data_dim, self.hidden_channels, out2, generator=g)
        else:
            self.data_dim = input_dim ** 2 * in_channel
            fc_dim, _ = transpose_padding_schedule(input_dim, len(self.hidden_channels))
            self.encoder = ConvEncoder2D(in_channel, self.hidden_channels, out2, fc_dim,
                                         generator=g)
        self.icnn1 = ICNN(latent_channel, self.icnn_channels[0], generator=g)
        self.icnn2 = ICNN(self.data_dim, self.icnn_channels[1], generator=g)

    @classmethod
    def for_dataset(cls, dataset: str, hidden_channels=None, **kwargs):
        defaults = resolve_dataset_defaults(dataset, hidden_channels)
        for k, v in LIDVAE_DATASET_OVERRIDES.get(dataset, {}).items():
            if k == "hidden_channels" and hidden_channels is not None:
                continue
            defaults[k] = v
        defaults.update(kwargs)
        return cls(**defaults)

    @property
    def il_factor(self) -> float:
        return self.inverse_lipschitz / 2.0

    def encode(self, x):
        mu, var = self.encoder(x).chunk(2, dim=1)
        # softplus keeps the "log_var" positive (model.py:812-816)
        return mu, F.softplus(var)

    def _brenier(self, icnn, v):
        """grad of [ICNN(v) + il_factor * ||v||^2] summed over the batch; with
        a graph while autograd records, else none."""
        record = torch.is_grad_enabled()
        with torch.enable_grad():
            if not (record and v.requires_grad):
                v = v.detach().requires_grad_()
            potential = (icnn(v) + self.il_factor * (v ** 2).sum(dim=1, keepdim=True)).sum()
            (g,) = torch.autograd.grad(potential, v, create_graph=record)
        return g

    def decode(self, z):
        x = self._brenier(self.icnn1, z)
        # B = eye(data_dim, latent): zero-pad the latent gradient up to the
        # data dimension, or cut it (model.py:771-775)
        pad = self.data_dim - x.shape[-1]
        x = F.pad(x, (0, pad)) if pad > 0 else x[:, :self.data_dim]
        y = self._brenier(self.icnn2, x)
        if self.data_type == "2d":
            y = y.reshape(y.shape[0], self.input_dim, self.input_dim, self.in_channel)
        return y

    def forward(self, x, eps=None):
        """eps [B, latent] or [1, B, latent]: z = mu + eps * exp(logvar / 2);
        eps None: z = mu."""
        mu, log_var = self.encode(x)
        if eps is None:
            z = mu
        else:
            if eps.dim() == 3:
                if eps.shape[0] != 1:
                    raise ValueError(f"LIDVAE draws one latent sample; eps {tuple(eps.shape)}")
                eps = eps[0]
            z = mu + eps * torch.exp(0.5 * log_var)
        return self.decode(z), mu, log_var, z, None

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        """(total, recon term, KL, 0): the KL is reported unscaled, as in JAX."""
        loss_recon = losses.recon_loss(x, recon, self.is_log_mse)
        loss_reg = losses.kl_divergence(mu, log_var)
        return (loss_recon + loss_reg * self.beta, loss_recon, loss_reg,
                torch.zeros((), device=x.device))
