"""Model construction from (experiment_type, model_params) -- port of
vae_song_tpu/models/registry.py: LIDVAE (lidvae), the FlexibleVAE family
(vae, nae, lrvae) and the set models (setvae, setlrvae)."""

import torch

from vae_song_tpu_torch.models.flexible import LRVAE, NaiveAE, VanillaVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.models.setvae import SetLRVAE, SetVAE


def build_model(exp_type: str, dataset: str, model_params: dict, beta: float = 1.0,
                alpha: float = 0.01, il: float = 0.0,
                generator: torch.Generator | None = None):
    """Build one model for a sweep point; the same `model_params` keys and
    defaults as the JAX registry (the FlexibleVAE family takes the
    dataset's architecture defaults, `encoder_type` conv and
    `decoder_type` mlp unless set). Weights are drawn from `generator` (a
    CPU torch.Generator; None uses torch's global one) on the CPU: move
    the model with `.to(device)`. `use_flash`, which only steers TPU
    execution, is not read."""
    mp = model_params
    if exp_type == "lidvae":
        return LIDVAE.for_dataset(dataset, hidden_channels=tuple(mp.get("hchans") or ()) or None,
                                  is_log_mse=mp.get("log_mse", False), inverse_lipschitz=il,
                                  beta=beta, generator=generator)
    if exp_type in ("vae", "nae", "lrvae"):
        hchans = tuple(mp.get("hchans") or ()) or None
        common = dict(hidden_channels=hchans,
                      encoder_type=mp.get("encoder_type", "conv"),
                      decoder_type=mp.get("decoder_type", "mlp"),
                      mixed_precision=mp.get("mixed_precision", False), generator=generator)
        if exp_type == "vae":
            return VanillaVAE.for_dataset(
                dataset, beta=beta, fixed_var=mp.get("fixed_var", False),
                residual_connection=mp.get("residual_connection", False), **common)
        if exp_type == "nae":
            return NaiveAE.for_dataset(dataset, **common)
        return LRVAE.for_dataset(
            dataset, beta=beta, alpha=alpha, z_source=mp.get("z_source", "Ex"),
            pwise_reg=mp.get("pwise_reg", False),
            residual_connection=mp.get("residual_connection", False), **common)
    if exp_type not in ("setvae", "setlrvae"):
        raise ValueError(f"Unsupported experiment type: {exp_type}")
    kwargs = dict(
        beta=beta,
        latent_channel=mp.get("latent_channel", 128),
        num_points=mp.get("num_points", 2048),
        encoder_hidden=tuple(mp.get("encoder_hidden", (128, 256, 512))),
        decoder_hidden=tuple(mp.get("decoder_hidden", (512, 256, 128))),
        pool_type=mp.get("pool_type", "max"),
        use_attention=mp.get("use_attention", True),
        d_model=mp.get("d_model", 256),
        num_heads=mp.get("num_heads", 4),
        num_encoder_layers=mp.get("num_encoder_layers", 2),
        num_decoder_layers=mp.get("num_decoder_layers", 2),
        ff_dim=mp.get("ff_dim", 512),
        attn_dropout=mp.get("attn_dropout", 0.0),
        mixed_precision=mp.get("mixed_precision", False),
        moe_experts=mp.get("moe_experts", 0),
        moe_capacity_factor=mp.get("moe_capacity_factor", 1.25),
        remat=mp.get("remat", False),
        generator=generator,
    )
    if exp_type == "setlrvae":
        return SetLRVAE(alpha=alpha, **kwargs)
    return SetVAE(**kwargs)
