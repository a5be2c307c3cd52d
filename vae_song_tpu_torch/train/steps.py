"""Train steps, eval step and apply functions (port of
vae_song_tpu/train/steps.py:make_train_step, make_accum_train_step,
make_eval_step and make_apply_fns).

The JAX functions close over a model and take the parameters as a train
state; here the model holds its parameters (and its BatchNorm
statistics), so the returned functions take only the data. Each call
puts the model in the mode it needs (train for the train steps, eval for
the others), so a trainer that builds both steps runs each in its own
mode. The randomness is in the arguments: the reparameterisation noise
`eps` (the steps of the reference sample z, L = 1) and, for training
dropout, the keep-mask source `dropout_rng` (a torch.Generator, or a
callable that hands out masks: nn.blocks.keep_mask), so tests feed both
packages the same numbers.
"""

import torch

from vae_song_tpu_torch.ops import losses

_TERMS = ("loss", "recon", "reg", "lr", "raw_kl")


def make_train_step(model, optimizer, grad_mode: str | None = None):
    """train_step(x, eps, wu_alpha, dropout_rng=None) -> {"loss", "recon",
    "reg", "lr", "raw_kl"}, each a 0-dim tensor on the model's device;
    the model's parameters are updated in place by one `optimizer` step.

    The gradient is the composite one the set models use: one backward
    of the total loss (JAX `make_grads_fn`, :45). `raw_kl` is the
    unscaled KL of this batch (JAX :76-80), which feeds the kl_adaptive
    warmup. After the call each parameter's `.grad` holds this step's
    gradient, clipped if the optimizer clips."""
    return make_accum_train_step(model, optimizer, 1, grad_mode)


def make_accum_train_step(model, optimizer, n_micro: int, grad_mode: str | None = None):
    """Gradient accumulation (JAX `make_accum_train_step`): one optimizer
    update from `n_micro` sequential microbatches, x and eps [B, latent]
    split along their first axis (B must divide by n_micro).

    As in JAX: the gradient is the mean of the per-microbatch gradients,
    accumulated as 0 + g_0 / n + g_1 / n + ...; the metrics are the mean
    of the per-microbatch metrics, accumulated the same way in f32; the
    BatchNorm statistics move microbatch after microbatch; the dropout
    masks are drawn microbatch after microbatch from `dropout_rng`.
    SetLRVAE's batch-summed latent-recon term therefore carries JAX's
    1/n_micro (each microbatch sums over its own clouds). n_micro = 1 is
    `make_train_step`."""
    mode = grad_mode or getattr(model, "grad_mode", "composite")
    if mode != "composite":
        raise NotImplementedError(
            f"grad_mode {mode!r}: the staged gradient belongs to the MLP families "
            "and is not ported yet; see ROADMAP.md Queue 1 item 9"
        )
    params = [p for p in optimizer.params if p.requires_grad]

    def train_step(x, eps, wu_alpha=0.0, dropout_rng=None):
        model.train()
        optimizer.zero_grad()
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch of {b} does not divide over {n_micro} microbatches")
        acc, m_acc = None, None
        for xi, ei in zip(x.split(b // n_micro), eps.split(b // n_micro)):
            outs = model(xi, ei, dropout_rng)
            total, rec, reg, lr = model.loss(xi, *outs, wu_alpha=wu_alpha)
            grads = torch.autograd.grad(total, params, allow_unused=True)
            with torch.no_grad():
                raw_kl = losses.kl_divergence(outs[1], outs[2])
                m = torch.stack([total, rec, reg, lr, raw_kl]).float()
                if n_micro == 1:
                    acc, m_acc = list(grads), m
                    continue
                m_acc = (0.0 if m_acc is None else m_acc) + m / n_micro
                if acc is None:
                    acc = [None] * len(params)
                for i, g in enumerate(grads):
                    if g is not None:
                        acc[i] = g / n_micro if acc[i] is None else acc[i] + g / n_micro
        for p, g in zip(params, acc):
            p.grad = g
        optimizer.step()
        return dict(zip(_TERMS, m_acc.detach().unbind()))

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
