"""Eval step and apply functions (port of
vae_song_tpu/train/steps.py:make_eval_step and make_apply_fns).

The JAX functions close over a model and take the parameters as a train
state; here the model holds its parameters, so the returned functions
take only the data. Both put the model in eval mode and run under
torch.inference_mode(). The reparameterisation noise `eps` is an
argument: the eval step of the reference samples z (L = 1), and tests
feed both packages the same numbers.
"""

import torch


def make_eval_step(model):
    """eval_step(x, eps, wu_alpha) -> {"loss", "recon", "reg", "lr"}, each
    a 0-dim tensor on the model's device."""
    model.eval()

    def eval_step(x, eps, wu_alpha=0.0):
        with torch.inference_mode():
            outs = model(x, eps)
            total, rec, reg, lr = model.loss(x, *outs, wu_alpha=wu_alpha)
        return {"loss": total, "recon": rec, "reg": reg, "lr": lr}

    return eval_step


def make_apply_fns(model):
    """(encode(x), decode(z), forward(x, eps=None)) in eval mode under
    torch.inference_mode(). forward without eps decodes from mu."""
    model.eval()

    def encode(x):
        with torch.inference_mode():
            return model.encode(x)

    def decode(z):
        with torch.inference_mode():
            return model.decode(z)

    def forward(x, eps=None):
        with torch.inference_mode():
            return model(x, eps)

    return encode, decode, forward
