"""The FlexibleVAE family (port of vae_song_tpu/models/flexible.py): a VAE
with MLP or convolutional encoder and decoder, and its variants NaiveAE,
VanillaVAE (beta-VAE) and LRVAE (latent reconstruction, trained with the
staged gradient, train/steps.py).

As in the JAX package:

  * images are NHWC at the API (the convolutions read them through a
    channels-last view, nn/blocks.py); the conv encoder flattens NHWC and
    the conv decoder reshapes its first block's output to (B, fc, fc, h0)
    NHWC, so the wide Dense layers see their inputs in the JAX order;
  * per-dataset defaults (`DATASET_DEFAULTS`, `for_dataset`), and the
    ConvTranspose pyramid's crop schedule (`transpose_padding_schedule`);
  * MLPEncoder1D applies BatchNorm and LeakyReLU to its (mu, logvar)
    output too, a quirk of the reference kept on purpose;
  * under `mixed_precision` the trunk's Dense and Conv layers compute in
    bf16, BatchNorm promotes to f32, and the (mu, logvar) head and the
    reconstruction's last layer compute in f32;
  * `forward` draws L Monte-Carlo latents: its `eps` [L, B, latent] is the
    reparameterisation noise (None decodes from mu, L = 1); recon is the
    mean of the L decodes, and the latent-reconstruction pass decodes the
    detached z and re-encodes it. Every pass runs in the model's mode, so
    in training the encoder's and the decoder's BatchNorm statistics move
    twice a step each: encode(x), decode(z), decode(z.detach()),
    encode(recon_lr), the order of Flax's mutable `batch_stats`.

Module names follow the Flax tree through the weight map (weights.py):
`mlp` / `res_mlp` / `res_conv` hold a stack's MLPBlock /
ResidualMLPBlock / ResidualConvBlock children in order, `head` is a
stack's last Dense, `up` the conv decoder's ConvTranspose -> BatchNorm
steps and `out_conv` its last convolution.
"""

from typing import Tuple

import torch
from torch import nn

from vae_song_tpu_torch.nn import initializers as init
from vae_song_tpu_torch.nn.blocks import (BatchNorm, Conv, ConvTranspose, Dense, MLPBlock,
                                          ResidualConvBlock, ResidualMLPBlock, lrelu)
from vae_song_tpu_torch.ops import losses

# Per-dataset architecture defaults (model.py:94-120)
DATASET_DEFAULTS = {
    "celeba": dict(in_channel=3, latent_channel=128, hidden_channels=(32, 64, 128, 256), input_dim=64),
    "mnist": dict(in_channel=1, latent_channel=28, hidden_channels=(32, 64, 128), input_dim=28),
    "fashionmnist": dict(in_channel=1, latent_channel=28, hidden_channels=(32, 64, 128), input_dim=28),
    "cifar10": dict(in_channel=3, latent_channel=128, hidden_channels=(32, 64, 128, 256), input_dim=32),
    "omniglot": dict(in_channel=1, latent_channel=32, hidden_channels=(32, 64, 128, 256), input_dim=28),
    "pinwheel": dict(in_channel=2, latent_channel=2, hidden_channels=(2, 2, 2, 2), input_dim=1),
    "chessboard": dict(in_channel=2, latent_channel=2, hidden_channels=(2, 2, 2, 2), input_dim=1),
}


def resolve_dataset_defaults(dataset: str, hidden_channels=None):
    if dataset not in DATASET_DEFAULTS:
        raise ValueError(f"Invalid dataset: {dataset}")
    d = dict(DATASET_DEFAULTS[dataset])
    if hidden_channels is not None:
        d["hidden_channels"] = tuple(hidden_channels)
    d["data_type"] = "1d" if dataset in ("pinwheel", "chessboard") else "2d"
    return d


def transpose_padding_schedule(input_dim: int, depth: int):
    """Output-padding schedule for the ConvTranspose pyramid
    (model.py:140-145). Returns (fc_dim, [pad_0 ... pad_{depth-1}])."""
    fc = input_dim
    tp = []
    for _ in range(depth):
        tp.append((fc + 1) % 2)
        fc = (fc - 1) // 2 + 1
    tp.reverse()
    return fc, tp


def _mlp_stack(dims, residual, dtype, generator):
    """Blocks between consecutive widths of `dims`."""
    block = ResidualMLPBlock if residual else MLPBlock
    return [block(i, o, dtype, generator) for i, o in zip(dims, dims[1:])]


# ---------------------------------------------------------------- encoders


class MLPEncoder1D(nn.Module):
    """MLP blocks over `hidden_channels`, then one more block to
    `out_features` in f32 (BatchNorm and LeakyReLU on (mu, logvar) too);
    residual blocks with `residual`."""

    def __init__(self, in_features: int, hidden_channels: Tuple[int, ...], out_features: int,
                 residual: bool = False, compute_dtype=None, generator=None):
        super().__init__()
        blocks = _mlp_stack((in_features, *hidden_channels), residual, compute_dtype, generator)
        blocks += _mlp_stack((hidden_channels[-1], out_features), residual, torch.float32,
                             generator)
        self.residual = residual
        if residual:
            self.res_mlp = nn.ModuleList(blocks)
        else:
            self.mlp = nn.ModuleList(blocks)

    def forward(self, x):
        for block in (self.res_mlp if self.residual else self.mlp):
            x = block(x)
        return x


class MLPEncoder2D(nn.Module):
    """Flatten (NHWC), MLP blocks over `hidden_channels` and one to
    `out_features`, then an f32 Dense head."""

    def __init__(self, in_features: int, hidden_channels: Tuple[int, ...], out_features: int,
                 compute_dtype=None, generator=None):
        super().__init__()
        self.mlp = nn.ModuleList(_mlp_stack((in_features, *hidden_channels, out_features), False,
                                            compute_dtype, generator))
        self.head = Dense(out_features, out_features, dtype=torch.float32, generator=generator)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        for block in self.mlp:
            x = block(x)
        return self.head(x)


class ConvEncoder2D(nn.Module):
    """Per hidden width a stride-2 and a stride-1 ResidualConvBlock (NHWC),
    flatten NHWC, an MLP block to `out_features`, an f32 Dense head."""

    def __init__(self, in_channel: int, hidden_channels: Tuple[int, ...], out_features: int,
                 fc_dim: int, compute_dtype=None, generator=None):
        super().__init__()
        blocks, prev = [], in_channel
        for ch in hidden_channels:
            blocks.append(ResidualConvBlock(prev, ch, 2, compute_dtype, generator))
            blocks.append(ResidualConvBlock(ch, ch, 1, compute_dtype, generator))
            prev = ch
        self.res_conv = nn.ModuleList(blocks)
        self.mlp = nn.ModuleList([MLPBlock(prev * fc_dim * fc_dim, out_features, compute_dtype,
                                           generator)])
        self.head = Dense(out_features, out_features, dtype=torch.float32, generator=generator)

    def forward(self, x):
        for block in self.res_conv:
            x = block(x)
        return self.head(self.mlp[0](x.reshape(x.shape[0], -1)))


# ---------------------------------------------------------------- decoders


class MLPDecoder1D(nn.Module):
    """MLP blocks over `hidden_channels` (decoder order), then an f32 Dense
    head to `out_features`; with `residual`, residual blocks ending in an
    f32 residual block instead of the head."""

    def __init__(self, latent: int, hidden_channels: Tuple[int, ...], out_features: int,
                 residual: bool = False, compute_dtype=None, generator=None):
        super().__init__()
        blocks = _mlp_stack((latent, *hidden_channels), residual, compute_dtype, generator)
        self.residual = residual
        if residual:
            blocks += _mlp_stack((hidden_channels[-1], out_features), True, torch.float32,
                                 generator)
            self.res_mlp = nn.ModuleList(blocks)
        else:
            self.mlp = nn.ModuleList(blocks)
            self.head = Dense(hidden_channels[-1], out_features, dtype=torch.float32,
                              generator=generator)

    def forward(self, z):
        for block in (self.res_mlp if self.residual else self.mlp):
            z = block(z)
        return z if self.residual else self.head(z)


class MLPDecoder2D(nn.Module):
    """latent -> D/2 -> D/2 -> D MLP blocks, an f32 Dense head, reshaped
    to NHWC images (D = input_dim^2 * in_channel)."""

    def __init__(self, latent: int, in_channel: int, input_dim: int, compute_dtype=None,
                 generator=None):
        super().__init__()
        d_full = input_dim ** 2 * in_channel
        d_half = d_full // 2
        self.shape = (input_dim, input_dim, in_channel)
        self.mlp = nn.ModuleList(_mlp_stack((latent, d_half, d_half, d_full), False,
                                            compute_dtype, generator))
        self.head = Dense(d_full, d_full, dtype=torch.float32, generator=generator)

    def forward(self, z):
        for block in self.mlp:
            z = block(z)
        return self.head(z).reshape(z.shape[0], *self.shape)


class UpBlock(nn.Module):
    """The JAX ConvDecoder2D's UpConv -> BatchNorm -> LeakyReLU step."""

    def __init__(self, in_features: int, out_features: int, output_padding: int,
                 compute_dtype=None, generator=None):
        super().__init__()
        self.conv = ConvTranspose(in_features, out_features, output_padding, compute_dtype,
                                  generator)
        self.norm = BatchNorm(out_features)

    def forward(self, x):
        return lrelu(self.norm(self.conv(x)))


class ConvDecoder2D(nn.Module):
    """An MLP block to h0 * fc^2 reshaped to (B, fc, fc, h0) NHWC, a
    ResidualConvBlock, the up-sampling steps over `hidden_channels`
    (decoder order, widest first) cropped by `transpose_padding`, then a
    3x3 f32 convolution to `in_channel` (stride 1, padding 1; init with
    the fan of torch's ConvTranspose2d, 9 * in_channel)."""

    def __init__(self, latent: int, in_channel: int, hidden_channels: Tuple[int, ...],
                 fc_dim: int, transpose_padding: Tuple[int, ...], compute_dtype=None,
                 generator=None):
        super().__init__()
        h0 = hidden_channels[0]
        self.fc_dim, self.h0 = fc_dim, h0
        self.mlp = nn.ModuleList([MLPBlock(latent, h0 * fc_dim * fc_dim, compute_dtype,
                                           generator)])
        self.res_conv = nn.ModuleList([ResidualConvBlock(h0, h0, 1, compute_dtype, generator)])
        outs = (*hidden_channels[1:], hidden_channels[-1])
        ins = (h0, *outs[:-1])
        self.up = nn.ModuleList(UpBlock(i, o, p, compute_dtype, generator)
                                for i, o, p in zip(ins, outs, transpose_padding))
        bound = init.torch_linear_bound(9 * in_channel)
        self.out_conv = Conv(hidden_channels[-1], in_channel, 3, 1, 1, torch.float32,
                             weight_bound=bound, bias_bound=bound, generator=generator)

    def forward(self, z):
        x = self.mlp[0](z).reshape(z.shape[0], self.fc_dim, self.fc_dim, self.h0)
        x = self.res_conv[0](x)
        for step in self.up:
            x = step(x)
        return self.out_conv(x)


# ---------------------------------------------------------------- the models


class FlexibleVAE(nn.Module):
    """Configurable VAE (model.py:69-501). `forward(x, eps)` returns
    (recon, mu, log_var, z_stack_detached, z_recon_stack) as the JAX
    model's __call__ does; `loss` is the variant's."""

    variational = True
    # the gradient the trainer takes; LRVAE overrides it with "staged"
    grad_mode = "composite"

    def __init__(self, in_channel=1, latent_channel=32, hidden_channels=(32, 64, 128),
                 input_dim=28, beta=1.0, alpha=0.0, is_log_mse=False, z_source="Ex",
                 pwise_reg=False, encoder_type="mlp", decoder_type="mlp",
                 residual_connection=False, fixed_var=False, data_type="2d",
                 mixed_precision=False, generator=None):
        super().__init__()
        self.in_channel, self.latent_channel = in_channel, latent_channel
        self.hidden_channels, self.input_dim = tuple(hidden_channels), input_dim
        self.beta, self.alpha, self.is_log_mse = beta, alpha, is_log_mse
        self.z_source, self.pwise_reg, self.fixed_var = z_source, pwise_reg, fixed_var
        self.encoder_type, self.decoder_type = encoder_type, decoder_type
        self.residual_connection, self.data_type = residual_connection, data_type
        self.mixed_precision = mixed_precision
        fc_dim, tp = transpose_padding_schedule(input_dim, len(self.hidden_channels))
        cdt = torch.bfloat16 if mixed_precision else None
        hidden, g, out2 = self.hidden_channels, generator, latent_channel * 2
        if data_type == "1d" and encoder_type == "mlp":
            self.encoder = MLPEncoder1D(in_channel, hidden, out2, residual_connection, cdt, g)
        elif encoder_type == "mlp":
            self.encoder = MLPEncoder2D(in_channel * input_dim ** 2, hidden, out2, cdt, g)
        elif encoder_type == "conv":
            self.encoder = ConvEncoder2D(in_channel, hidden, out2, fc_dim, cdt, g)
        else:
            raise ValueError(f"Invalid encoder type: {data_type} {encoder_type}")
        rev = tuple(reversed(hidden))
        if data_type == "1d" and decoder_type == "mlp":
            self.decoder = MLPDecoder1D(latent_channel, rev, in_channel, residual_connection,
                                        cdt, g)
        elif decoder_type == "mlp":
            self.decoder = MLPDecoder2D(latent_channel, in_channel, input_dim, cdt, g)
        elif decoder_type == "conv":
            self.decoder = ConvDecoder2D(latent_channel, in_channel, rev, fc_dim, tuple(tp),
                                         cdt, g)
        else:
            raise ValueError(f"Invalid decoder type: {data_type} {decoder_type}")

    @classmethod
    def for_dataset(cls, dataset: str, hidden_channels=None, **kwargs):
        defaults = resolve_dataset_defaults(dataset, hidden_channels)
        defaults.update(kwargs)
        return cls(**defaults)

    def encode(self, x):
        mu, log_var = self.encoder(x).chunk(2, dim=1)
        return mu, log_var

    def decode(self, z):
        return self.decoder(z)

    def forward(self, x, eps=None):
        """eps [L, B, latent]: z = mu + eps * exp(logvar / 2) for each of the
        L samples; eps None: z = mu (L = 1)."""
        mu, log_var = self.encode(x)
        b = x.shape[0]
        z_stack = mu[None] if eps is None else mu[None] + eps * torch.exp(0.5 * log_var)[None]
        n_samples = z_stack.shape[0]
        z_flat = z_stack.reshape(-1, z_stack.shape[-1])              # [L * B, latent]
        # the reconstruction, full graph
        recon_flat = self.decode(z_flat)
        # the latent reconstruction: gradients reach the decoder and the
        # second encoder pass only
        z_recon_flat, _ = self.encode(self.decode(z_flat.detach()))
        recon = recon_flat.reshape(n_samples, b, *recon_flat.shape[1:]).mean(dim=0)
        z_recon = z_recon_flat.reshape(n_samples, b, -1)
        return recon, mu, log_var, z_stack.detach(), z_recon

    # --- the z-source forwards of the reference (model.py:450-501) ---

    def _maybe_fixed_var(self, log_var):
        if self.fixed_var is not False:
            return torch.log(torch.ones_like(log_var) * self.fixed_var)
        return log_var

    @staticmethod
    def _sample(mu, log_var, eps):
        return mu if eps is None else mu + eps * torch.exp(0.5 * log_var)

    def forward_ae(self, x):
        z, _ = self.encode(x)
        return self.decode(z), z, 0.0, z, 0.0

    def forward_ex(self, x, eps=None):
        """Latent recon with z encoded from x; eps [B, latent] or None."""
        mu, log_var = self.encode(x)
        log_var = self._maybe_fixed_var(log_var)
        z = self._sample(mu, log_var, eps)
        recon = self.decode(z)
        z_recon, _ = self.encode(recon)
        return recon, mu, log_var, z, z_recon

    def forward_qzx(self, x, eps=None):
        """Latent recon with mu as the target."""
        mu, log_var = self.encode(x)
        log_var = self._maybe_fixed_var(log_var)
        recon = self.decode(self._sample(mu, log_var, eps))
        z_recon, _ = self.encode(recon)
        return recon, mu, log_var, mu, z_recon

    def forward_pz(self, x, eps=None, eps_prior=None):
        """Latent recon with z drawn from the prior: z_input = eps_prior *
        exp(1/2) (eps_prior [B, latent], the JAX forward's second draw)."""
        mu, log_var = self.encode(x)
        log_var = self._maybe_fixed_var(log_var)
        z = self._sample(mu, log_var, eps)
        z_input = eps_prior * torch.exp(0.5 * torch.ones_like(log_var))
        z_recon, _ = self.encode(self.decode(z_input))
        return self.decode(z), mu, log_var, z_input, z_recon

    def forward_legacy(self, x, eps=None, eps_prior=None):
        """The z_source dispatch (model.py:450-461)."""
        if not self.variational:
            return self.forward_ae(x)
        if self.z_source == "pz":
            return self.forward_pz(x, eps, eps_prior)
        if self.z_source == "qzx":
            return self.forward_qzx(x, eps)
        if self.z_source == "Ex":
            return self.forward_ex(x, eps)
        raise ValueError("Invalid z_source")

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        """(total, recon term, scaled reg term, scaled lr term)."""
        raise NotImplementedError


class NaiveAE(FlexibleVAE):
    """MSE-only autoencoder (model.py:506-528)."""

    variational = False

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        loss_recon = losses.recon_loss(x, recon, self.is_log_mse)
        zero = torch.zeros((), device=x.device)
        return loss_recon, loss_recon, zero, zero


class VanillaVAE(FlexibleVAE):
    """beta-VAE: recon + beta * KL; the latent-recon term is reported, not
    trained (model.py:530-553)."""

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        loss_recon = losses.recon_loss(x, recon, self.is_log_mse)
        loss_reg = losses.kl_divergence(mu, log_var)
        if z_input is not None and z_recon is not None:
            loss_lr = losses.latent_recon_loss(z_input, z_recon)
        else:
            loss_lr = torch.zeros((), device=x.device)
        return loss_recon + loss_reg * self.beta, loss_recon, loss_reg, loss_lr


class LRVAE(FlexibleVAE):
    """Latent-reconstruction VAE (model.py:573-633), trained with the
    staged gradient."""

    grad_mode = "staged"
    # the trainer runs the kl_adaptive warmup of wu_alpha for this model
    has_warmup = True

    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(alpha=alpha, **kwargs)

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        loss_recon = losses.recon_loss(x, recon, self.is_log_mse)
        loss_lr = losses.latent_recon_loss(z_input, z_recon)
        loss_reg = losses.kl_divergence(mu, log_var)
        if self.pwise_reg:
            loss_reg = losses.pairwise_reg(loss_reg, z_input)
        reg_scaled = loss_reg * self.beta
        lr_scaled = loss_lr * self.alpha * wu_alpha
        return loss_recon + reg_scaled + lr_scaled, loss_recon, reg_scaled, lr_scaled
