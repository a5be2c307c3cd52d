"""Sequence parallelism (parallel/sp.py; ops/attention.py's
sequence_sharded_attention and ring_attention; ops/chamfer.py:chamfer_sp)
on two gloo ranks on the CPU: the ring and the all-gather against full
attention, forward and gradients (JAX tests/test_sp_step.py), the
sharded Chamfer against the full one, the SP step with and without the
ring against the port's single-device step and against JAX
make_sp_train_step on a 1 x 2 mesh of conftest's virtual devices, the
routing by the sequence context and not by the shape, and the trainer's
sequence_parallel path against the single-device trainer
(test_trainer_tp_sp.py). DP x SP on 2 x 2 is
tests/test_torch_parallel_dryrun.py's, with this file's helpers.

One process group of two ranks for the file
(tests/torch_parallel_worker.py); the references run in this process."""

import numpy as np
import pytest
import torch

from jax_parity import jax_sharded_step, sharded_jax_gaps
from test_torch_parallel_tp import TRAIN, TRAINER_MODEL
from torch_parallel_worker import _model, start_ranks, wait_ranks
from vae_song_tpu_torch.ops.attention import attention_plain
from vae_song_tpu_torch.ops.chamfer import chamfer_distance
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import make_optimizer
from vae_song_tpu_torch.train.steps import make_grads_fn

WORLD, LR, WU = 2, 1e-2, 0.5
TINY = dict(exp_type="setlrvae", dataset="shapenet", beta=0.1, alpha=0.1, seed=5,
            model_params=dict(latent_channel=8, num_points=32, d_model=16, num_heads=2,
                              ff_dim=32, num_encoder_layers=2, num_decoder_layers=1))
# two heads of 64 at 256 points: a rank's 128 are packed_ok shapes, which
# the shape alone would send to the packed kernel's route
WIDE = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=6,
            model_params=dict(latent_channel=8, num_points=256, d_model=128, num_heads=2,
                              ff_dim=64, num_encoder_layers=1, num_decoder_layers=1))


def step_phase(name, spec, strategy, mesh, b, seed, tiled=True, **kw):
    """A `strategy` phase: the global batch x [b, N, 3] and noise whose
    rows repeat one block per 'data' row (JAX draws the same block on
    every shard under patch_eps), or with tiled=False a block of its own
    for every row (the port's references only: a row that took another
    row's block would show)."""
    rng = np.random.default_rng(seed)
    mp = spec["model_params"]
    rows = mesh[0]
    x = rng.normal(size=(b, mp["num_points"], 3)).astype(np.float32)
    eps = rng.normal(size=(b // rows if tiled else b, mp["latent_channel"])).astype(np.float32)
    return dict(spec, fn="strategy", name=name, strategy=strategy, mesh=mesh, x=x,
                eps=np.tile(eps, (rows, 1)) if tiled else eps, wu=WU, lr=LR, **kw)


def dp_reference(phase, rows):
    """The port's step under the data-parallel convention over `rows`
    equal slices of the batch: the mean of the single-device gradients
    and metrics of the slices, then one update (the clip, if any, on the
    mean). rows = 1 is the single-device step. Returns (metrics, {name:
    grad}, model after the update)."""
    model = _model(phase)
    opt = make_optimizer(model.parameters(), lr=phase["lr"], grad_clip=phase.get("grad_clip"))
    params = list(model.parameters())
    x, eps = torch.from_numpy(phase["x"]), torch.from_numpy(phase["eps"])
    acc, m_acc = [None] * len(params), 0.0
    for xi, ei in zip(x.chunk(rows), eps.chunk(rows)):
        grads, m = make_grads_fn(model, params)(xi, ei, phase["wu"])
        m_acc = m_acc + m / rows
        acc = [a if g is None else g / rows if a is None else a + g / rows
               for a, g in zip(acc, grads)]
    for p, g in zip(params, acc):
        p.grad = g
    opt.step()
    names = [n for n, _ in model.named_parameters()]
    return (dict(zip(("loss", "recon", "reg", "lr", "raw_kl"), m_acc.tolist())),
            {n: p.grad.numpy() for n, p in zip(names, params) if p.grad is not None}, model)


def gaps(got, ref, lr=LR):
    """(loss terms, max relative; gradients, relative L2; share of
    parameter elements the update leaves apart by more than lr/100) of a
    rank's step against `dp_reference`. The key biases' gradient is zero
    analytically: roundoff on both sides, left out."""
    m, grads, model = ref
    loss = max(abs(got["metrics"][k] - m[k]) / max(abs(m[k]), 1e-6) for k in m)
    keys = [k for k in grads if not k.endswith("key.bias")]
    assert set(got["grads"]) == set(grads)
    g = (sum(float(((got["grads"][k] - grads[k]) ** 2).sum()) for k in keys)
         / sum(float((grads[k] ** 2).sum()) for k in keys)) ** 0.5
    after = dict(model.named_parameters())
    share = float(np.mean(np.concatenate([
        (np.abs(got["state"][k] - after[k].detach().numpy()) > lr / 100).reshape(-1)
        for k in keys])))
    return loss, g, share


# Bounds on (loss terms, gradients, share) against the port's single-device
# step: both sides round the attention's q, k, v, weights and their
# cotangents to bf16, so a last-bit difference of the f32 sums (the sharded
# attention sums other slices, the ring other chunks, and it computes its
# backward from the row log-sum-exp in f32) lands some elements one bf16
# rounding apart. Measured over the three SP steps here: loss terms 7.8e-5
# (ring; all-gather 8.3e-8), gradients 8.9e-4, share 4.5e-3 (sp_wide: the
# first Adam update moves a ~0 gradient of the other sign 2 lr); each bound
# about 10x that.
BOUNDS = (1e-3, 1e-2, 5e-2)
# Bounds against JAX's step of the same strategy: tests/test_torch_train.py's
# CPU_F32_BOUNDS for these models (first-step loss terms, gradients,
# share), as tests/test_torch_parallel_tp.py holds TP to JAX's TP step.
JAX_BOUNDS = (5e-4, 0.05, 0.6, 0.0)

STEPS = {
    "sp": step_phase("sp", TINY, "sp", [1, WORLD], 4, 0),
    "sp_ring": step_phase("sp_ring", TINY, "sp_ring", [1, WORLD], 4, 0),
    "sp_wide": step_phase("sp_wide", WIDE, "sp", [1, WORLD], 2, 1),
}
JAX_STEPS = ("sp", "sp_ring")


def _ops_phase(seed=2, b=2, n=32, h=2, d=8):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    return dict(fn="sp_ops", name="ops", n=WORLD, scale=1.0 / np.sqrt(d),
                q=f(b, n, h, d), k=f(b, n, h, d), v=f(b, n, h, d), do=f(b, n, h, d),
                pred=f(b, n, 3), gt=f(b, n, 3))


OPS = _ops_phase()


def run_file(tmp_path_factory, name, world, steps, jax_steps, trainers, single_models,
             extra=(), epochs=TRAIN["epochs"]):
    """`steps`, the trainer phases {phase name: (model spec, train_and_test
    kwargs)} and the `extra` phases on `world` ranks; while they run, the
    single-device trainer run of each of `single_models` ({key: model
    spec}; `epochs` epochs, as the trainer phases), the port's references
    of the steps ({name: dp_reference}) and JAX's steps of `jax_steps`."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp(name)
    train = dict(TRAIN, epochs=epochs)
    phases = [*steps.values(), *extra,
              *(dict(spec, fn="trainer", name=n, kwargs=dict(train, output_root=str(tmp / n),
                                                              **kw))
                for n, (spec, kw) in trainers.items())]
    ranks = start_ranks({"phases": phases}, world, tmp)
    single = {k: train_and_test(_model(spec), device="cpu", output_root=str(tmp / f"single_{k}"),
                                **train) for k, spec in single_models.items()}
    refs = {n: dp_reference(p, p["mesh"][0]) for n, p in steps.items()}
    jax_refs = {n: jax_sharded_step(steps[n], _model(steps[n])) for n in jax_steps}
    outs = wait_ranks(ranks)
    torch.set_num_threads(threads)
    return dict(outs=outs, tmp=tmp, single=single, refs=refs, jax_refs=jax_refs)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    yield run_file(tmp_path_factory, "sp", WORLD, STEPS, JAX_STEPS, {
        "train_sp": (TRAINER_MODEL, {"sequence_parallel": 2}),
        "train_sp_ring": (TRAINER_MODEL, {"sequence_parallel": 2,
                                          "sequence_parallel_ring": True}),
    }, {"set": TRAINER_MODEL}, extra=[OPS])


def merged(runs, name, n):
    """The gradients of the first n ranks' step outputs merged (each rank
    holds the replicated entries and, under PP, its stage's layers)."""
    got = dict(runs["outs"][0][name])
    got["grads"] = {k: v for r in range(n) for k, v in runs["outs"][r][name]["grads"].items()}
    return got


def check_step(runs, name, n, bounds=BOUNDS):
    """A step against the port's reference within `bounds`; every rank of
    the mesh holds the same state."""
    got = merged(runs, name, n)
    d = gaps(got, runs["refs"][name])
    assert all(a <= b for a, b in zip(d, bounds)), (d, bounds)
    for r in range(1, n):
        for k, v in got["state"].items():
            np.testing.assert_array_equal(runs["outs"][r][name]["state"][k], v, err_msg=k)


def check_jax(runs, name, n, bounds=JAX_BOUNDS):
    d = sharded_jax_gaps(merged(runs, name, n), runs["jax_refs"][name], LR)
    assert all(a <= b for a, b in zip(d, bounds)), (d, bounds)


def check_trainer(runs, name, world, single="set"):
    """The trainer phase train_<name> against the single-device run of
    `single` from the same seed, data and noise (eval loss rtol 1e-4;
    parameters within the update budget n_steps * lr, JAX
    test_trainer_tp_sp.py:47); only rank 0 wrote. The attention's key
    biases are left out of the parameters: their gradient is zero
    analytically, so each update moves them by the sign of roundoff, +-lr,
    on either side."""
    import os

    got = runs["outs"][0]["train_" + name]
    want_state, want = runs["single"][single]
    np.testing.assert_allclose(got["eval"]["loss"], want["eval"]["loss"], rtol=1e-4)
    steps = want_state.step
    assert got["step"] == steps
    for k, v in want_state.model.state_dict().items():
        if not k.endswith("key.bias"):
            np.testing.assert_allclose(got["state"][k], v.numpy(), atol=steps * TRAIN["lr"],
                                       rtol=0, err_msg=k)
    for r in range(1, world):
        assert not os.path.exists(runs["outs"][r]["train_" + name]["result_dir"])


# ---------------------------------------------------------------- the ops


def _assemble(outs, key, field):
    return np.concatenate([o["ops"][key][field] for o in outs[:WORLD]], axis=1)


def _full_attention():
    q, k, v = (torch.from_numpy(OPS[n]).requires_grad_() for n in ("q", "k", "v"))
    out = attention_plain(q, k, v, OPS["scale"])
    out.backward(torch.from_numpy(OPS["do"]))
    return {"out": out.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
            "dv": v.grad.numpy()}


@pytest.mark.parametrize("route", ["all_gather", "ring"])
def test_sharded_attention_matches_full_attention(runs, route):
    """Each rank's queries against every rank's keys: the output and the
    q/k/v gradients, assembled over the point shards, are full
    attention's (bf16 operands on both sides: the ring's per-chunk
    running max and its f32 backward move them by bf16 roundings)."""
    want = _full_attention()
    for field, want_t in want.items():
        got = _assemble(runs["outs"], route, field)
        np.testing.assert_allclose(got, want_t, atol=2e-2, rtol=0, err_msg=field)


def test_ring_matches_all_gather(runs):
    """The two sequence-parallel routes agree with each other more closely
    than with anything else: the same bf16 operands, other sums."""
    for field in ("out", "dq", "dk", "dv"):
        np.testing.assert_allclose(_assemble(runs["outs"], "ring", field),
                                   _assemble(runs["outs"], "all_gather", field),
                                   atol=2e-2, rtol=0, err_msg=field)


def test_chamfer_sp_matches_full_chamfer(runs):
    """The mean of the per-shard values is the full Chamfer, and the shard
    gradients, over the shard count, assemble its gradient."""
    pred, gt = (torch.from_numpy(OPS[n]).requires_grad_() for n in ("pred", "gt"))
    want = chamfer_distance(pred, gt)
    want.backward()
    got = [o["ops"]["chamfer"] for o in runs["outs"][:WORLD]]
    np.testing.assert_allclose(np.mean([g["value"] for g in got]), want.detach().item(), rtol=1e-6)
    for name, t in (("dpred", pred), ("dgt", gt)):
        grad = np.concatenate([g[name] for g in got], axis=1) / WORLD
        np.testing.assert_allclose(grad, t.grad.numpy(), atol=1e-7, rtol=1e-5)


# ---------------------------------------------------------------- the step


@pytest.mark.parametrize("name", list(STEPS))
def test_sp_step_matches_single_device(runs, name):
    """SP on 1 x 2 with the all-gather and with the ring: the port's
    single-device step on the global batch."""
    check_step(runs, name, WORLD)


@pytest.mark.parametrize("name", JAX_STEPS)
def test_sp_step_matches_jax(runs, name):
    """The same steps against JAX make_sp_train_step (ring=False, True) on a
    1 x 2 mesh of virtual devices, from the same weights, clouds and eps."""
    check_jax(runs, name, WORLD)


def test_sp_eval_matches_train_terms(runs):
    """The eval step after the update runs the sharded forward too: finite,
    the same on both ranks."""
    for name in STEPS:
        ev = [runs["outs"][r][name]["eval"] for r in range(WORLD)]
        assert ev[0] == ev[1] and all(np.isfinite(v) for v in ev[0].values())


def test_sp_routes_by_context_not_shape(runs):
    """Under SP every self-attention takes the sharded attention (the
    all-gather through the plain attention, or the ring), even where a
    rank's shard is a packed_ok shape (sp_wide: 128 points of two 64-wide
    heads a rank); no dense-kernel route runs."""
    for name in STEPS:
        routes = runs["outs"][0][name]["routes"]
        assert (routes["attention_plain"] == 0) == (name == "sp_ring"), routes
        assert routes["dense_attention_fwd"] == routes["dense_attention"] == 0, routes


def test_sp_refuses_training_dropout():
    """Attention-weight dropout in training is refused under SP (JAX
    :409-413); eval is dropout-free and runs."""
    import torch.distributed as dist

    from vae_song_tpu_torch.nn.sync import sequence_sharded
    from vae_song_tpu_torch.ops.attention import MultiHeadAttention

    from vae_song_tpu_torch.parallel.mesh import _free_port

    mha = MultiHeadAttention(16, 2, dropout_rate=0.1, self_attention=True)
    x = torch.randn(1, 8, 16)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{_free_port()}", rank=0,
                            world_size=1)
    try:
        with sequence_sharded(dist.group.WORLD):
            with pytest.raises(NotImplementedError, match="sequence parallelism"):
                mha.train()(x, x, torch.Generator().manual_seed(0))
            assert mha.eval()(x, x).shape == x.shape
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------- the trainer


@pytest.mark.parametrize("name", ["sp", "sp_ring"])
def test_sp_trainer_matches_single_device(runs, name):
    """sequence_parallel 2 (with and without sequence_parallel_ring) on two
    ranks lands on the single-device run; only rank 0 wrote."""
    check_trainer(runs, name, WORLD)
