"""Train step, eval step and apply functions (port of
vae_song_tpu/train/steps.py:make_train_step, make_eval_step and
make_apply_fns).

The JAX functions close over a model and take the parameters as a train
state; here the model holds its parameters, so the returned functions
take only the data. Each call puts the model in the mode it needs
(train for the train step, eval for the others), so a trainer that
builds both steps runs each in its own mode. The reparameterisation
noise `eps` is an argument: the steps of the reference sample z (L = 1),
and tests feed both packages the same numbers.
"""

import torch

from vae_song_tpu_torch.ops import losses


def make_train_step(model, optimizer, grad_mode: str | None = None):
    """train_step(x, eps, wu_alpha) -> {"loss", "recon", "reg", "lr",
    "raw_kl"}, each a 0-dim tensor on the model's device; the model's
    parameters are updated in place by one `optimizer` step.

    The gradient is the composite one the set models use: one backward
    of the total loss (JAX `make_grads_fn`, :45). `raw_kl` is the
    unscaled KL of this batch (JAX :76-80), which feeds the kl_adaptive
    warmup. After the call each parameter's `.grad` holds this step's
    gradient, clipped if the optimizer clips."""
    mode = grad_mode or getattr(model, "grad_mode", "composite")
    if mode != "composite":
        raise NotImplementedError(
            f"grad_mode {mode!r}: the staged gradient belongs to the MLP families "
            "and is not ported yet; see ROADMAP.md Queue 1 item 9"
        )

    def train_step(x, eps, wu_alpha=0.0):
        model.train()
        optimizer.zero_grad()
        outs = model(x, eps)
        total, rec, reg, lr = model.loss(x, *outs, wu_alpha=wu_alpha)
        total.backward()
        optimizer.step()
        with torch.no_grad():
            raw_kl = losses.kl_divergence(outs[1], outs[2])
        return {"loss": total.detach(), "recon": rec.detach(), "reg": reg.detach(),
                "lr": lr.detach(), "raw_kl": raw_kl}

    return train_step


def make_eval_step(model):
    """eval_step(x, eps, wu_alpha) -> {"loss", "recon", "reg", "lr"}, each
    a 0-dim tensor on the model's device; eval mode, under
    torch.inference_mode()."""

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.inference_mode():
            outs = model(x, eps)
            total, rec, reg, lr = model.loss(x, *outs, wu_alpha=wu_alpha)
        return {"loss": total, "recon": rec, "reg": reg, "lr": lr}

    return eval_step


def make_apply_fns(model):
    """(encode(x), decode(z), forward(x, eps=None)) in eval mode under
    torch.inference_mode(). forward without eps decodes from mu."""

    def encode(x):
        model.eval()
        with torch.inference_mode():
            return model.encode(x)

    def decode(z):
        model.eval()
        with torch.inference_mode():
            return model.decode(z)

    def forward(x, eps=None):
        model.eval()
        with torch.inference_mode():
            return model(x, eps)

    return encode, decode, forward
