"""Optimizer and train state (port of vae_song_tpu/train/state.py).

The JAX package chains optax transformations: an optional gradient clip,
then Adam (b1 0.9, b2 0.999, eps 1e-8) whose learning rate follows
`optax.cosine_decay_schedule(lr, total_steps)`. The port keeps optax's
semantics where they differ from torch's defaults:

  * Adam: the port's own foreach update (`Adam` below) with optax's
    arithmetic, the bias corrections 1 - b^t in f32 included (torch.optim
    .Adam computes them in double), its learning rate taken from the
    schedule at every step. A parameter without a gradient (the
    kv-length-1 cross-attention's query/key projections) is left as it
    is, as optax's Adam leaves a parameter whose gradient is zero.
  * cosine schedule: step k (0-based) uses lr * 0.5 * (1 + cos(pi *
    min(k, T) / T)).
  * clip, norm_type 2: `optax.clip_by_global_norm`, which leaves the
    gradients alone below max_norm and otherwise scales them by
    max_norm / norm. This is NOT `torch.nn.utils.clip_grad_norm_`,
    which scales by max_norm / (norm + 1e-6).
  * clip, other norm_type: the JAX package's `clip_by_global_pnorm`
    (torch's rule: min(1, max_norm / (p-norm + 1e-6))).
  * clip, value: `optax.clip`, element-wise into [-v, v].
  * an unknown clip_type raises.

The moments, the count and the train step are state that a checkpoint
carries (`adam_state`, `load_optax_state`), in optax's layout, so a JAX
TrainState's optimizer state carries across as well.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from vae_song_tpu_torch import weights
from vae_song_tpu_torch.nn.sync import local_tensor as _local


def cosine_decay(lr: float, total_steps: int):
    """`optax.cosine_decay_schedule(lr, total_steps)` as a function of the
    0-based step count."""
    if not total_steps > 0:
        raise ValueError(f"cosine decay needs positive total_steps, got {total_steps}")

    def schedule(step: int) -> float:
        k = min(step, total_steps)
        return lr * 0.5 * (1.0 + math.cos(math.pi * k / total_steps))

    return schedule


def _grads(params):
    return [p.grad for p in params if p.grad is not None]


def global_pnorm(grads, p: float) -> torch.Tensor:
    """Global p-norm over every gradient element (p = inf: the largest
    absolute element)."""
    flat = [g.float().reshape(-1) for g in grads]
    if p == float("inf"):
        return torch.stack([g.abs().max() for g in flat]).max()
    return sum((g.abs() ** p).sum() for g in flat) ** (1.0 / p)


def _clip_by_global_norm(max_norm: float):
    @torch.no_grad()
    def clip(grads):
        if not grads:
            return
        norm = global_pnorm(grads, 2.0)
        if norm < max_norm:
            return
        for g in grads:
            g.copy_((g / norm.to(g.dtype)) * max_norm)

    return clip


def _clip_by_global_pnorm(max_norm: float, p: float):
    @torch.no_grad()
    def clip(grads):
        if not grads:
            return
        scale = torch.clamp(max_norm / (global_pnorm(grads, p) + 1e-6), max=1.0)
        for g in grads:
            g.mul_(scale.to(g.dtype))

    return clip


def _clip_by_value(clip_value: float):
    @torch.no_grad()
    def clip(grads):
        for g in grads:
            g.clamp_(-clip_value, clip_value)

    return clip


def make_clip(grad_clip: dict | None):
    """The in-place gradient clip a `grad_clip` config entry asks for, or
    None (absent, null or `enabled: false`)."""
    if not (grad_clip and grad_clip.get("enabled", False)):
        return None
    clip_type = grad_clip.get("clip_type", "norm")
    if clip_type == "norm":
        max_norm = float(grad_clip.get("max_norm", 1.0))
        norm_type = float(grad_clip.get("norm_type", 2.0))
        if norm_type == 2.0:
            return _clip_by_global_norm(max_norm)
        return _clip_by_global_pnorm(max_norm, norm_type)
    if clip_type == "value":
        return _clip_by_value(float(grad_clip.get("clip_value", 1.0)))
    raise ValueError(f"unknown clip_type {clip_type!r}")


class Adam:
    """`optax.scale_by_adam` followed by the scaled learning rate, over a
    list of parameters, with optax's arithmetic: the moments as
    (1 - b) * g + b * m, the bias corrections 1 - b^t computed in f32
    (b = 0.999 is 0.99900001 in f32; torch.optim.Adam computes them in
    double), the update m_hat / (sqrt(v_hat) + eps) scaled by -lr. One
    count for all parameters, as optax keeps it; a parameter without a
    gradient keeps its moments and its value, as optax's zero gradient
    leaves them."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]

    @torch.no_grad()
    def step(self, lr: float, count: int):
        """One update; `count` is the 1-based number of this update."""
        live = [i for i, p in enumerate(self.params) if p.grad is not None]
        if not live:
            return
        # elementwise, so a sharded parameter (a DTensor) updates its
        # local slice from the slices of its gradient and moments
        ps = [_local(self.params[i]) for i in live]
        gs = [_local(self.params[i].grad) for i in live]
        mus = [_local(self.mu[i]) for i in live]
        nus = [_local(self.nu[i]) for i in live]
        torch._foreach_mul_(mus, self.b1)
        torch._foreach_add_(mus, torch._foreach_mul(gs, 1.0 - self.b1))
        torch._foreach_mul_(nus, self.b2)
        torch._foreach_add_(nus, torch._foreach_mul(torch._foreach_mul(gs, gs), 1.0 - self.b2))
        f32 = np.float32
        bc1 = float(f32(1.0) - f32(self.b1) ** f32(count))
        bc2 = float(f32(1.0) - f32(self.b2) ** f32(count))
        denom = torch._foreach_div(nus, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        upd = torch._foreach_div(mus, bc1)
        torch._foreach_div_(upd, denom)
        torch._foreach_mul_(upd, -float(f32(lr)))
        torch._foreach_add_(ps, upd)


class Optimizer:
    """optax.chain(clip?, adam(schedule)) over a list of parameters.
    `step()` clips the gradients in place and takes one Adam update at
    the schedule's rate for the current count; `count` is the number of
    updates taken."""

    def __init__(self, params, lr: float = 1e-2, total_steps: int | None = None,
                 grad_clip: dict | None = None):
        self.params = list(params)
        self.schedule = cosine_decay(lr, total_steps) if total_steps is not None else (lambda _: lr)
        self.grad_clip = grad_clip
        self.clip = make_clip(grad_clip)
        self.adam = Adam(self.params, b1=0.9, b2=0.999, eps=1e-8)
        self.count = 0

    def lr(self) -> float:
        """The learning rate the next update uses."""
        return self.schedule(self.count)

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self):
        if self.clip is not None:
            self.clip(_grads(self.params))
        self.adam.step(self.lr(), self.count + 1)
        self.count += 1


def make_optimizer(params, lr: float = 1e-2, total_steps: int | None = None,
                   grad_clip: dict | None = None) -> Optimizer:
    """Adam + optional cosine decay over `total_steps` + optional clip
    (JAX `make_optimizer`, :60)."""
    return Optimizer(params, lr, total_steps, grad_clip)


@dataclass
class TrainState:
    """The model (which holds the parameters), its optimizer and the
    number of train steps taken; under FSDP (parallel/fsdp.py) also the
    parameters FSDP2 manages."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0
    fsdp_params: list = field(default_factory=list)


def _slot_names(state: TrainState) -> list[str]:
    """The parameter name of each of the optimizer's slots."""
    names = {id(p): name for name, p in state.model.named_parameters()}
    return [names[id(p)] for p in state.optimizer.params]


def adam_state(state: TrainState) -> dict:
    """The optimizer's state as optax's ScaleByAdamState holds it:
    {"count": updates taken, "mu": {parameter name: tensor}, "nu": ...},
    the tensors the live moments (not copies)."""
    names = _slot_names(state)
    adam = state.optimizer.adam
    return {"count": state.optimizer.count, "mu": dict(zip(names, adam.mu)),
            "nu": dict(zip(names, adam.nu))}


def _adam_slot(tree: dict) -> dict:
    """The one ScaleByAdamState node {count, mu, nu} in an optax chain
    state as `flax.serialization.to_state_dict` gives it: the clip slot
    first when a clip is configured, then (ScaleByAdamState, the
    schedule's slot)."""
    if set(tree) == {"count", "mu", "nu"}:
        return tree
    found = [_adam_slot(sub) for sub in tree.values() if isinstance(sub, dict) and sub]
    found = [f for f in found if f is not None]
    if len(found) > 1:
        raise ValueError("optimizer state holds more than one Adam slot")
    return found[0] if found else None


@torch.no_grad()
def load_optax_state(state: TrainState, opt_state: dict, step: int) -> TrainState:
    """Set the port's Adam moments and count and the train step from an
    optax chain state (nested dicts of numpy arrays in the Flax
    parameter layout, `flax.serialization.to_state_dict(opt_state)`) and
    a TrainState's `step`; the moments cross through
    vae_song_tpu_torch.weights. Returns `state`."""
    slot = _adam_slot(opt_state)
    if slot is None:
        raise ValueError("optimizer state holds no Adam slot {count, mu, nu}")
    keys = [name for name, _ in state.model.named_parameters()]
    mu = weights.params_to_state_dict(slot["mu"], keys)
    nu = weights.params_to_state_dict(slot["nu"], keys)
    adam = state.optimizer.adam
    for i, name in enumerate(_slot_names(state)):
        adam.mu[i].copy_(mu[name])
        adam.nu[i].copy_(nu[name])
    state.optimizer.count = int(slot["count"])
    state.step = int(step)
    return state
