"""`remat` in the port (models/setvae.py: each transformer layer under
torch.utils.checkpoint) against the port without it and against the JAX
package's `remat` (jax.checkpoint on each layer, vae_song_tpu/models/
setvae.py:267-277, 373-391), on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn import blocks
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

from jax_parity import grad_gap, one_thread, to_np  # noqa: F401

TINY = dict(latent_channel=8, num_points=16, d_model=16, num_heads=2, ff_dim=32)
# heads of 64 at N = 128: the packed attention route (K1 / K2 on the card,
# their plain versions here)
PACKED = dict(latent_channel=16, num_points=128, d_model=128, num_heads=2,
              num_encoder_layers=2, num_decoder_layers=2, ff_dim=64)
B, BETA, ALPHA, WU_ALPHA, LR = 4, 0.1, 0.5, 0.3, 1e-2

# one torch thread a test: pytest-xdist runs six processes on the same cores
pytestmark = pytest.mark.usefixtures("one_thread")


def _model(kind, mp, remat, seed=0):
    return build_model(kind, "shapenet", dict(mp, remat=remat), beta=BETA, alpha=ALPHA,
                       generator=torch.Generator().manual_seed(seed))


def _clouds(mp, seed):
    rng = np.random.default_rng(seed)
    return (torch.from_numpy((rng.normal(size=(B, mp["num_points"], 3)) * 0.5).astype(np.float32)),
            torch.from_numpy(rng.normal(size=(B, mp["latent_channel"])).astype(np.float32)))


def _step(model, x, eps, source=None):
    terms = make_train_step(model, make_optimizer(model.parameters(), lr=LR))(
        x, eps, WU_ALPHA, source)
    return ({k: float(v) for k, v in terms.items()},
            {k: p.grad.clone() for k, p in model.named_parameters() if p.grad is not None})


@pytest.mark.parametrize("kind,mp,mixed", [
    ("setvae", TINY, False),
    ("setvae", PACKED, False),
    ("setlrvae", PACKED, True),
])
def test_remat_is_an_identity_on_the_step(kind, mp, mixed):
    """One train step with and without remat from the same weights: the
    same loss terms and gradients. Only the decoder's first layer differs:
    under remat it runs its self-attention at full batch instead of once
    at batch 1 (JAX :391). Without remat that layer's backward takes the
    cotangent summed over the batch through attention's bf16 roundings
    (ROADMAP.md Queue 3, "the decoder's batch-constant first
    self-attention"), with remat each cloud's: its gradients move by about
    1e-3 relative, the rest by f32 roundoff. Loss terms to 1e-6 relative
    (measured 0), the gradient to 2e-3 relative L2 in f32 (measured
    4.5e-4 on TINY, 4.6e-8 on PACKED) and 2e-2 in bf16 (1.6e-3)."""
    mp = dict(mp, mixed_precision=mixed)
    x, eps = _clouds(mp, 1)
    (t_off, g_off), (t_on, g_on) = (_step(_model(kind, mp, r), x, eps) for r in (False, True))
    assert g_off.keys() == g_on.keys()
    rel = max(abs(t_on[k] - t_off[k]) / max(abs(t_off[k]), 1e-12) for k in t_off)
    gap = grad_gap(g_on, g_off, [k for k in g_off if not k.endswith("key.bias")])
    assert rel <= 1e-6 and gap <= (2e-2 if mixed else 2e-3), (rel, gap)


def test_remat_matches_jax_remat():
    """The port with remat against JAX with remat (tests/test_models.py:217
    holds JAX's remat to its own run without): mu as the latent, train
    mode, f32, the same weights; the loss to 1e-5 relative and the
    gradient to 1e-4 relative L2 (measured 3.1e-7 and 2.7e-6; the key
    biases, whose gradient is analytically zero, left out)."""
    port = _model("setvae", TINY, True)
    jmodel = jax_build_model("setvae", "shapenet", dict(TINY, remat=True), beta=BETA)
    params = weights.state_dict_to_variables(port.state_dict())["params"]
    pts = np.random.default_rng(7).normal(size=(2, TINY["num_points"], 3)).astype(np.float32)

    def loss_fn(p):
        outs = jmodel.apply({"params": p}, pts, latent_rand_sampling=False, train=True)
        return jmodel.loss(pts, *outs)[0]

    j_loss, j_grads = jax.value_and_grad(loss_fn)(jax.tree.map(jnp.asarray, params))
    port.train()
    x = torch.from_numpy(pts)
    loss = port.loss(x, *port(x))[0]
    loss.backward()
    keys = [k for k, _ in port.named_parameters()]
    want = weights.params_to_state_dict(to_np(j_grads), keys)
    got = {k: torch.zeros_like(want[k]) if p.grad is None else p.grad
           for k, p in port.named_parameters()}
    rel = abs(float(loss.detach()) - float(j_loss)) / abs(float(j_loss))
    gap = grad_gap(got, want, [k for k in keys if not k.endswith("key.bias")])
    assert rel <= 1e-5 and gap <= 1e-4, (rel, gap)


def _recording(monkeypatch):
    """Every keep mask drawn, in order."""
    drawn = []
    draw = blocks.keep_mask

    def keep_mask(source, shape, keep_prob, device):
        drawn.append(draw(source, shape, keep_prob, device))
        return drawn[-1]

    monkeypatch.setattr(blocks, "keep_mask", keep_mask)
    return drawn


class _Tape:
    """A callable mask source: fresh masks from a seeded generator."""

    def __init__(self, seed):
        self.gen = torch.Generator().manual_seed(seed)

    def __call__(self, shape, keep_prob):
        return torch.rand(shape, generator=self.gen) < keep_prob


@pytest.mark.parametrize("source", ["generator", "callable"])
def test_remat_replays_the_dropout_masks(monkeypatch, source):
    """attn_dropout 0.1: the backward's recompute of each layer draws the
    masks its first pass drew (a torch.Generator is set back to its state
    before the layer and restored after; a callable's masks are recorded
    and replayed), so the step equals the step without remat: loss terms
    to 1e-6 relative and the gradient to 1e-5 relative L2, and the
    generator ends where the run without remat leaves it."""
    mp = dict(PACKED, attn_dropout=0.1)
    x, eps = _clouds(mp, 2)

    def make_source():
        return torch.Generator().manual_seed(3) if source == "generator" else _Tape(3)

    src_off = make_source()
    t_off, g_off = _step(_model("setvae", mp, False), x, eps, src_off)
    drawn = _recording(monkeypatch)
    src_on = make_source()
    t_on, g_on = _step(_model("setvae", mp, True), x, eps, src_on)
    monkeypatch.undo()
    # each layer draws its masks twice, in its first pass and in its
    # recompute, which must be the same
    first, again = drawn[:len(drawn) // 2], drawn[len(drawn) // 2:]
    assert len(drawn) == 2 * len(first) and first
    assert all(torch.equal(a, b) for a, b in zip(first, _in_forward_order(again, mp)))
    gen_of = (lambda s: s) if source == "generator" else (lambda s: s.gen)
    assert torch.equal(gen_of(src_on).get_state(), gen_of(src_off).get_state())
    rel = max(abs(t_on[k] - t_off[k]) / max(abs(t_off[k]), 1e-12) for k in t_off)
    gap = grad_gap(g_on, g_off, [k for k in g_off if not k.endswith("key.bias")])
    assert rel <= 1e-6 and gap <= 1e-5, (rel, gap)


def _in_forward_order(again, mp):
    """The backward recomputes the layers last to first: regroup the
    recompute's masks in the first pass's order. An encoder layer draws 4
    masks (attention weights and output, the FFN's hidden activation and
    output), a decoder layer 6 (its cross-attention's weights and output
    too)."""
    sizes = [4] * mp["num_encoder_layers"] + [6] * mp["num_decoder_layers"]
    groups, i = [], 0
    for n in reversed(sizes):
        groups.append(again[i:i + n])
        i += n
    assert i == len(again)
    return [m for group in reversed(groups) for m in group]


def test_registry_reads_remat():
    m = build_model("setvae", "shapenet", dict(TINY, remat=True))
    assert m.encoder.remat and m.decoder.remat
    assert not build_model("setvae", "shapenet", TINY).encoder.remat
