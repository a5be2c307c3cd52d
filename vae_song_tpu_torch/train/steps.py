"""Train steps, eval step and apply functions (port of
vae_song_tpu/train/steps.py:make_train_step, make_accum_train_step,
make_eval_step and make_apply_fns).

The JAX functions close over a model and take the parameters as a train
state; here the model holds its parameters (and its BatchNorm
statistics), so the returned functions take only the data. Each call
puts the model in the mode it needs (train for the train steps, eval for
the others), so a trainer that builds both steps runs each in its own
mode. The randomness is in the arguments: the reparameterisation noise
`eps` ([B, latent] for the set models; [L, B, latent], L Monte-Carlo
samples, for the FlexibleVAE family) and, for training dropout (the set
models), the keep-mask source `dropout_rng` (a torch.Generator, or a
callable that hands out masks: nn.blocks.keep_mask), so tests feed both
packages the same numbers.

`make_grads_fn` (JAX :45) is the step's first half, the gradients and
the moved BatchNorm statistics of one batch, and `make_backward_fn` the
same taken with `.backward()` for the wrappers that reduce gradients in
their backward hooks (DDP, FSDP2; parallel/); a strategy reduces between
it and the optimizer update.

The gradient is the JAX `make_grads_fn`'s:

  * composite (every model but LRVAE, LIDVAE included, though it has an
    `encoder`): one backward of the total loss;
  * staged (LRVAE's `grad_mode`, or asked for): one forward and two
    pulls, g_main of (recon + scaled reg) and g_lr of the scaled
    latent-recon term, combined as g_main + g_lr with g_lr scaled by
    ENCODER_LR_LAMBDA on every parameter of the `encoder` submodule
    (BatchNorm's scale and bias included). The reference's backward
    (main.py:262-287) gives the same sum.
"""

import torch

from vae_song_tpu_torch.ops import losses

_TERMS = ("loss", "recon", "reg", "lr", "raw_kl")
ENCODER_LR_LAMBDA = 1e-4  # main.py:269


def _pull(loss, params, retain_graph=False):
    """d loss / d params, None where a parameter does not reach the loss
    (every one when the loss is a constant)."""
    if not loss.requires_grad:
        return [None] * len(params)
    return list(torch.autograd.grad(loss, params, retain_graph=retain_graph,
                                    allow_unused=True))


def _staged_grads(terms, params, encoder_ids):
    """g_main + g_lr, g_lr scaled by ENCODER_LR_LAMBDA on the encoder's
    parameters, from one graph (JAX: one vjp, two cotangent pulls)."""
    _, rec, reg, lr = terms
    g_main = _pull(rec + reg, params, retain_graph=True)
    g_lr = _pull(lr, params)
    out = []
    for p, a, b in zip(params, g_main, g_lr):
        if b is not None and id(p) in encoder_ids:
            b = b * ENCODER_LR_LAMBDA
        out.append(b if a is None else a if b is None else a + b)
    return out


def _raw_kl(model, outs):
    """The unscaled regulariser the reference stashes as last_kl_loss (the
    kl_adaptive warmup reads it): the KL of (mu, logvar), mixed with the
    batch-statistics KL when the model sets `pwise_reg`."""
    kl = losses.kl_divergence(outs[1], outs[2])
    if getattr(model, "pwise_reg", False) and outs[3] is not None:
        kl = losses.pairwise_reg(kl, outs[3])
    return kl


def _mode(model, grad_mode):
    mode = grad_mode or getattr(model, "grad_mode", "composite")
    if mode not in ("composite", "staged"):
        raise ValueError(f"unknown grad_mode {mode!r}")
    return mode


def _encoder_ids(model) -> set:
    encoder = getattr(model, "encoder", None)
    return {id(p) for p in encoder.parameters()} if encoder is not None else set()


def _metrics(model, terms, outs):
    with torch.no_grad():
        return torch.stack([*terms, _raw_kl(model, outs)]).float()


def make_grads_fn(model, params, grad_mode: str | None = None):
    """grads_fn(x, eps, wu_alpha, dropout_rng=None) -> (grads, metrics)
    (JAX `make_grads_fn`, :45): the gradient of one batch with respect to
    `params` (a list; None where a parameter does not reach the loss) and
    its metrics stacked [loss, recon, reg, lr, raw_kl] in f32. The model
    runs in train mode, so its BatchNorm statistics move: the new
    statistics are its buffers after the call. No parameter changes; a
    strategy reduces between this and the update (parallel/)."""
    mode = _mode(model, grad_mode)
    encoder_ids = _encoder_ids(model)

    def grads_fn(x, eps, wu_alpha=0.0, dropout_rng=None):
        model.train()
        outs = model(x, eps) if dropout_rng is None else model(x, eps, dropout_rng)
        terms = model.loss(x, *outs, wu_alpha=wu_alpha)
        if mode == "staged":
            grads = _staged_grads(terms, params, encoder_ids)
        else:
            grads = _pull(terms[0], params)
        return grads, _metrics(model, terms, outs)

    return grads_fn


def make_backward_fn(forward, model, params, grad_mode: str | None = None,
                     after_backward=None):
    """The gradient of `make_grads_fn` taken with `.backward()`, for the
    wrappers whose gradient reduction hooks into it (DDP's reducer,
    FSDP2's reduce-scatter): backward_fn(x, eps, wu_alpha, dropout_rng)
    -> metrics, leaving each parameter's `.grad` (None where it does not
    reach the loss). `forward(x, eps[, dropout_rng])` is the wrapped
    model's call; `after_backward()`, if given, runs after each backward
    pass (the reduction of the gradients the wrapper does not reduce).

    The staged gradient takes two passes, one forward and one backward
    each, since a wrapper reduces once per backward: first the scaled
    latent-recon term, whose encoder share is then scaled by
    ENCODER_LR_LAMBDA (the reduction is linear, so scaling after it is
    the same), then recon + scaled reg; the sum is g_main + g_lr. The
    BatchNorm buffers and a torch.Generator dropout source are set back
    before the second pass, so both passes see the same statistics and
    masks."""
    mode = _mode(model, grad_mode)
    encoder_ids = _encoder_ids(model)

    def run(x, eps, wu_alpha, dropout_rng):
        outs = forward(x, eps) if dropout_rng is None else forward(x, eps, dropout_rng)
        return outs, model.loss(x, *outs, wu_alpha=wu_alpha)

    def backward(loss):
        if loss.requires_grad:
            loss.backward()
        if after_backward is not None:
            after_backward()

    def backward_fn(x, eps, wu_alpha=0.0, dropout_rng=None):
        model.train()
        for p in params:
            p.grad = None
        if mode == "composite":
            outs, terms = run(x, eps, wu_alpha, dropout_rng)
            backward(terms[0])
            return _metrics(model, terms, outs)
        buffers = [b.detach().clone() for b in model.buffers()]
        rng_state = dropout_rng.get_state() if isinstance(dropout_rng, torch.Generator) else None
        _, terms = run(x, eps, wu_alpha, dropout_rng)
        backward(terms[3])
        g_lr = []
        for p in params:
            g = p.grad
            if g is not None and id(p) in encoder_ids:
                g = g * ENCODER_LR_LAMBDA
            g_lr.append(g)
            p.grad = None
        with torch.no_grad():
            for b, saved in zip(model.buffers(), buffers):
                b.copy_(saved)
        if rng_state is not None:
            dropout_rng.set_state(rng_state)
        outs, terms = run(x, eps, wu_alpha, dropout_rng)
        backward(terms[1] + terms[2])
        for p, b in zip(params, g_lr):
            if b is not None:
                p.grad = b if p.grad is None else p.grad + b
        return _metrics(model, terms, outs)

    return backward_fn


def make_train_step(model, optimizer, grad_mode: str | None = None):
    """train_step(x, eps, wu_alpha, dropout_rng=None) -> {"loss", "recon",
    "reg", "lr", "raw_kl"}, each a 0-dim tensor on the model's device;
    the model's parameters are updated in place by one `optimizer` step.

    The gradient is the model's `grad_mode` (composite, or LRVAE's
    staged) unless `grad_mode` names one (JAX `make_grads_fn`, :45).
    `raw_kl` is the unscaled regulariser of this batch (JAX :76-80),
    which feeds the kl_adaptive warmup. After the call each parameter's
    `.grad` holds this step's gradient, clipped if the optimizer clips."""
    return make_accum_train_step(model, optimizer, 1, grad_mode)


def make_accum_train_step(model, optimizer, n_micro: int, grad_mode: str | None = None):
    """Gradient accumulation (JAX `make_accum_train_step`): one optimizer
    update from `n_micro` sequential microbatches, x split along its
    first axis and eps along its batch axis, the second to last (eps
    [B, latent] along dim 0, [L, B, latent] along dim 1); B must divide
    by n_micro.

    As in JAX: the gradient is the mean of the per-microbatch gradients,
    accumulated as 0 + g_0 / n + g_1 / n + ...; the metrics are the mean
    of the per-microbatch metrics, accumulated the same way in f32; the
    BatchNorm statistics move microbatch after microbatch; the dropout
    masks are drawn microbatch after microbatch from `dropout_rng`.
    SetLRVAE's batch-summed latent-recon term therefore carries JAX's
    1/n_micro (each microbatch sums over its own clouds). n_micro = 1 is
    `make_train_step`."""
    params = [p for p in optimizer.params if p.requires_grad]
    grads_fn = make_grads_fn(model, params, grad_mode)

    def train_step(x, eps, wu_alpha=0.0, dropout_rng=None):
        optimizer.zero_grad()
        b = x.shape[0]
        if b % n_micro:
            raise ValueError(f"batch of {b} does not divide over {n_micro} microbatches")
        acc, m_acc = None, None
        for xi, ei in zip(x.split(b // n_micro), eps.split(b // n_micro, dim=eps.dim() - 2)):
            grads, m = grads_fn(xi, ei, wu_alpha, dropout_rng)
            with torch.no_grad():
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
    torch.no_grad(). Not torch.inference_mode(): LIDVAE's decode takes a
    gradient inside its forward (models/lidvae.py), which autograd refuses
    on inference tensors."""

    def eval_step(x, eps, wu_alpha=0.0):
        model.eval()
        with torch.no_grad():
            outs = model(x, eps)
            total, rec, reg, lr = model.loss(x, *outs, wu_alpha=wu_alpha)
        return {"loss": total, "recon": rec, "reg": reg, "lr": lr}

    return eval_step


def make_apply_fns(model):
    """(encode(x), decode(z), forward(x, eps=None)) in eval mode under
    torch.no_grad() (as the eval step), returning tensors with no graph.
    forward without eps decodes from mu."""

    def encode(x):
        model.eval()
        with torch.no_grad():
            return model.encode(x)

    def decode(z):
        model.eval()
        with torch.no_grad():
            return model.decode(z)

    def forward(x, eps=None):
        model.eval()
        with torch.no_grad():
            return model(x, eps)

    return encode, decode, forward
