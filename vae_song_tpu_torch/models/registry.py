"""Model construction from (experiment_type, model_params) -- port of
vae_song_tpu/models/registry.py for the families ported so far."""

import torch

from vae_song_tpu_torch.models.setvae import SetLRVAE, SetVAE

# families not ported yet -> the ROADMAP.md item that ports them
_NOT_PORTED = {
    "vae": "Queue 1 item 9 (nn/blocks.py and models/flexible.py)",
    "nae": "Queue 1 item 9 (nn/blocks.py and models/flexible.py)",
    "lrvae": "Queue 1 item 9 (nn/blocks.py and models/flexible.py)",
    "lidvae": "Queue 1 item 12 (LIDVAE and the Lipschitz analysis)",
}


def build_model(exp_type: str, dataset: str, model_params: dict, beta: float = 1.0,
                alpha: float = 0.01, generator: torch.Generator | None = None):
    """Build one model for a sweep point; the same `model_params` keys as
    the JAX registry. Weights are drawn from `generator` (a CPU
    torch.Generator; None uses torch's global one) on the CPU: move the
    model with `.to(device)`. Keys that only steer TPU execution
    (`use_flash`) or training memory (`remat`) do not change the forward
    pass and are not read."""
    if exp_type in _NOT_PORTED:
        raise NotImplementedError(
            f"experiment type {exp_type!r} is not ported to PyTorch yet; see "
            f"ROADMAP.md {_NOT_PORTED[exp_type]}"
        )
    if exp_type not in ("setvae", "setlrvae"):
        raise ValueError(f"Unsupported experiment type: {exp_type}")
    mp = model_params
    if mp.get("moe_experts", 0) > 0:
        raise NotImplementedError(
            "moe_experts > 0 is not ported yet; see ROADMAP.md Queue 1 item 15"
        )
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
        generator=generator,
    )
    if exp_type == "setlrvae":
        return SetLRVAE(alpha=alpha, **kwargs)
    return SetVAE(**kwargs)
