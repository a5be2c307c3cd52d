"""Data parallelism (parallel/mesh.py: DistributedDataParallel) and FSDP
(parallel/fsdp.py: FSDP2 `fully_shard`) on two gloo ranks on the CPU.

DP against the JAX package's `make_dp_train_step` and `make_dp_eval_step`
on two of conftest's virtual devices (JAX tests/test_parallel.py:30,53,
67,78): per-shard loss and gradients, the gradients, the shards' new
BatchNorm statistics and the metrics averaged, LRVAE's staged gradient and
its batch-summed latent-recon term by the DDP convention. JAX draws the
noise with `patch_eps`, so every shard draws the same block, and each
port rank takes that block. Also the trainer's DP path with its
rank-0-only writes, and data_parallel on one device.

FSDP: the placement rule (JAX tests/test_fsdp.py:27,41 and the TP x FSDP
merge; against JAX fsdp_param_specs on the same trees), the step against
the single-device step on the global batch and against JAX
make_fsdp_train_step on two virtual devices for each model family
(test_fsdp.py:47: BatchNorm statistics of the global batch, LRVAE's
staged gradient and batch-summed latent-recon term not divided by the
rank count), the clip over sharded gradients against optax, the first
rank's state taken by every rank, the trainer path with its
rank-0-only writes (test_fsdp.py:83,109) and checkpoints across
strategies both ways (JAX tests/test_resume.py:178).

One process group for the file (tests/torch_parallel_worker.py) runs
every phase; the single-device and JAX references run here, in this
process.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jax_parity import (flex_inputs, flex_pair, grad_gap, grads_capture,  # noqa: F401
                        jax_sharded_step, jax_spec_at, max_rel, one_thread, patch_eps,
                        port_spec_as_flax, sharded_jax_gaps, to_np)
from torch_parallel_worker import _model, start_ranks, wait_ranks
from vae_song_tpu.parallel import make_dp_eval_step as jax_dp_eval
from vae_song_tpu.parallel import fsdp_param_specs as jax_fsdp_param_specs
from vae_song_tpu.parallel import make_dp_train_step as jax_dp_step
from vae_song_tpu.parallel import make_mesh as jax_make_mesh
from vae_song_tpu.parallel import replicate_state, shard_batch
from vae_song_tpu.train import state as jax_state
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.parallel.fsdp import (fsdp_param_specs, merge_tp_fsdp_specs,
                                              sharded_fraction)
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import TrainState, make_clip, make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

WORLD = 2
LR, WU = 1e-2, 0.5
LRVAE = dict(exp_type="lrvae", dataset="pinwheel", beta=0.01, alpha=0.01, seed=0,
             model_params=dict(hchans=[8, 8], encoder_type="mlp", decoder_type="mlp"))
DEEPSETS = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=1,
                model_params=dict(latent_channel=8, num_points=32, use_attention=False,
                                  encoder_hidden=[16, 32], decoder_hidden=[32, 16]))
ATTENTION = dict(exp_type="setlrvae", dataset="shapenet", beta=0.1, alpha=0.1, seed=2,
                 model_params=dict(latent_channel=8, num_points=32, d_model=16, num_heads=2,
                                   ff_dim=32, num_encoder_layers=2, num_decoder_layers=1))
MNIST = dict(exp_type="vae", dataset="mnist", beta=0.01, seed=3,
             model_params=dict(hchans=[128], encoder_type="mlp", decoder_type="mlp"))
# lr 1e-3: at 1e-2 this model's 128 steps are chaotic (eval loss ~140,
# where a last-bit difference of the first step grows to 5%)
TRAIN_LR = 1e-3
TRAIN = dict(epochs=2, batch_size=512, dataset_name="mnist", resultname="res_fsdp",
             dataset_params={"fake": True, "seed": 0}, visualize_artifacts=False,
             progress=False, seed=0, checkpoint_every=1, lr=TRAIN_LR)
CLIPS = [
    {"enabled": True, "clip_type": "norm", "max_norm": 0.05, "norm_type": 2.0},
    {"enabled": True, "clip_type": "norm", "max_norm": 1e6, "norm_type": 2.0},
    {"enabled": True, "clip_type": "norm", "max_norm": 0.05, "norm_type": 1.0},
    {"enabled": True, "clip_type": "norm", "max_norm": 0.05, "norm_type": float("inf")},
    {"enabled": True, "clip_type": "value", "clip_value": 0.01},
]


def _inputs(spec, b, seed):
    rng = np.random.default_rng(seed)
    if spec["dataset"] == "pinwheel":
        return (rng.normal(size=(b, 2)).astype(np.float32),
                rng.normal(size=(1, b, 2)).astype(np.float32))
    n, latent = spec["model_params"]["num_points"], spec["model_params"]["latent_channel"]
    return (rng.normal(size=(b, n, 3)).astype(np.float32),
            rng.normal(size=(b, latent)).astype(np.float32))


def _step_phase(name, spec, b, seed, **kw):
    x, eps = _inputs(spec, b, seed)
    return dict(spec, fn="sharded", name=name, strategy="fsdp", mesh=[WORLD, 1],
                min_shard_elems=0, x=x, eps=eps, wu=WU, lr=LR, **kw)


STEPS = {
    "lrvae": _step_phase("lrvae", LRVAE, 16, 0),
    "lrvae_pwise": _step_phase("lrvae_pwise", dict(
        LRVAE, model_params=dict(LRVAE["model_params"], pwise_reg=True)), 16, 1),
    "deepsets": _step_phase("deepsets", DEEPSETS, 8, 2),
    "attention": _step_phase("attention", ATTENTION, 8, 3),
}


def _single_step(phase):
    """The port's single-device step on the global batch: (metrics,
    {name: grad}, model after the update)."""
    model = _model(phase)
    opt = make_optimizer(model.parameters(), lr=phase["lr"], grad_clip=phase.get("grad_clip"))
    m = make_train_step(model, opt)(torch.from_numpy(phase["x"]), torch.from_numpy(phase["eps"]),
                                    phase["wu"])
    grads = {n: p.grad.numpy() for n, p in model.named_parameters() if p.grad is not None}
    return {k: float(v) for k, v in m.items()}, grads, model


def _single_run(root, **kw):
    return train_and_test(_model(MNIST), device="cpu", output_root=str(root), **dict(TRAIN, **kw))


DP_B, DP_WU = 16, 0.3
DP_ARCH = dict(encoder_type="mlp", decoder_type="mlp", hchans=[8, 8, 8])
DP_SET = dict(exp_type="setvae", dataset="shapenet", beta=0.1, seed=4,
              model_params=dict(latent_channel=8, num_points=32, d_model=16, num_heads=2,
                                ff_dim=32, num_encoder_layers=1, num_decoder_layers=1))
DP_TRAIN = dict(epochs=2, batch_size=8, dataset_name="shapenet", resultname="res_dp",
                dataset_params={"fake": True, "num_samples": 32, "num_points": 32,
                                "num_test_samples": 8},
                visualize_artifacts=False, progress=False, seed=0, lr=1e-3)
# tests/test_torch_flexible_train.py F32_BOUNDS, the same models in f32:
# loss terms (max relative), gradients (relative L2), share of parameter
# elements Adam's first update moves apart by more than lr/100, running
# statistics (max relative)
F32_BOUNDS = (1e-5, 1e-4, 1e-3, 1e-5)


def _dp_phase(kind):
    """The phase that runs the port's DP steps from JAX's initial weights,
    and what the JAX side needs to run its own on the same inputs."""
    jmodel, params, bs, port = flex_pair(kind, "mlp1d", alpha=0.5)
    x = flex_inputs("mlp1d", DP_B, seed=7)
    eps = np.random.default_rng(8).normal(size=(1, DP_B // WORLD, 2)).astype(np.float32)
    phase = dict(fn="dp", name="dp_" + kind, exp_type=kind, dataset="pinwheel", beta=0.01,
                 alpha=0.5, model_params=DP_ARCH, flax_params=params, flax_batch_stats=bs,
                 x=x, eps=eps, wu=DP_WU, lr=LR)
    return phase, (jmodel, params, bs, port, x, eps)


def _jax_dp(jmodel, params, bs, port, x, eps, monkeypatch):
    """The JAX DP eval step and train step on a 2-device mesh."""
    patch_eps(monkeypatch, eps)
    mesh = jax_make_mesh(n_data=WORLD, devices=jax.devices()[:WORLD])
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=LR))
    state = replicate_state(jax_state.TrainState.create(params, bs, tx), mesh)
    xs = shard_batch(jnp.asarray(x), mesh)
    ev = jax_dp_eval(jmodel, mesh)(state, xs, jnp.float32(DP_WU), jax.random.PRNGKey(1))
    state, m = jax_dp_step(jmodel, tx, mesh)(state, xs, jnp.float32(DP_WU), jax.random.PRNGKey(0))
    keys = [k for k, _ in port.named_parameters()]
    want = {"metrics": {k: float(v) for k, v in m.items()},
            "eval": {k: float(v) for k, v in ev.items()},
            "grads": weights.params_to_state_dict(to_np(state.opt_state[0]), keys),
            "params": weights.params_to_state_dict(to_np(state.params), keys),
            "stats": to_np(state.batch_stats)}
    return want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every phase on two ranks: FSDP's, then DP's with JAX's DP steps
    as their references, and the single-device run whose checkpoint the
    ranks resume."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    tmp = tmp_path_factory.mktemp("fsdp")
    single_state, single = _single_run(tmp / "single")
    single_ckpt = os.path.join(single["result_dir"], "params", "ckpt_0.pkl")
    shard = dict(MNIST, fn="trainer")
    phases = [*STEPS.values(),
              dict(STEPS["lrvae"], fn="clip", name="clip", clips=CLIPS),
              dict(STEPS["lrvae"], fn="replicated", name="replicated", seed_by_rank=True),
              dict(shard, name="train",
                   kwargs=dict(TRAIN, fsdp=True, output_root=str(tmp / "fsdp"))),
              # the train phase's checkpoint, found when the phase runs
              dict(shard, name="resume",
                   kwargs=dict(TRAIN, fsdp=True, output_root=str(tmp / "res"),
                               resume_from=str(tmp / "fsdp" / "results" / "*" / "*" / "params"
                                               / "ckpt_0.pkl"))),
              dict(shard, name="from_single", kwargs=dict(TRAIN, fsdp=True,
                                                          output_root=str(tmp / "from_single"),
                                                          resume_from=single_ckpt))]
    jax_inputs = {}
    for kind in ("vae", "lrvae"):
        phase, jax_inputs[kind] = _dp_phase(kind)
        phases.append(phase)
    phases.append(dict(DP_SET, fn="trainer", name="dp_train",
                       kwargs=dict(DP_TRAIN, data_parallel=True, output_root=str(tmp / "dp"))))
    ranks = start_ranks({"phases": phases}, WORLD, tmp)
    # JAX's DP steps and the single-device steps while the ranks run
    mp, wants = pytest.MonkeyPatch(), {}
    for kind, inputs in jax_inputs.items():
        wants[kind] = _jax_dp(*inputs, mp)
        mp.undo()
    refs = {name: _single_step(phase) for name, phase in STEPS.items()}
    jax_refs = {name: jax_sharded_step(phase, _model(phase)) for name, phase in STEPS.items()}
    outs = wait_ranks(ranks)
    torch.set_num_threads(threads)
    yield dict(outs=outs, tmp=tmp, single=single, single_state=single_state, wants=wants,
               refs=refs, jax_refs=jax_refs,
               fsdp_ckpt=glob.glob(next(p for p in phases if p["name"] == "resume")
                                   ["kwargs"]["resume_from"]))


# ---------------------------------------------------------------- the placement rule


def test_leaf_spec_rule():
    specs = fsdp_param_specs({"big": (784, 128), "tall": (17, 128 * 200), "bias": (128,),
                              "odd": (999, 333)}, n_shards=8)
    assert specs["big"] == ("data", None)      # largest divisible axis: 784
    assert specs["tall"] == (None, "data")     # only the last axis divides
    assert specs["bias"] == ()                 # too small: whole
    assert specs["odd"] == ()                  # nothing divides 8: whole


def test_leaf_spec_prefers_largest_axis():
    assert fsdp_param_specs({"k": (784, 128)}, 8, min_shard_elems=0)["k"] == ("data", None)


def test_leaf_spec_ties_follow_the_flax_layout():
    """A square Dense weight [out, in] is the Flax kernel [in, out]: the
    tie goes to Flax's last axis, the port's first."""
    name = "encoder.layers.0.ff_up.weight"
    assert fsdp_param_specs({name: (256, 256)}, 8)[name] == ("data", None)
    assert fsdp_param_specs({"plain": (256, 256)}, 8)["plain"] == (None, "data")


CONV = dict(MNIST, model_params=dict(hchans=[8, 16], encoder_type="conv", decoder_type="conv"))


@pytest.mark.parametrize("spec", [LRVAE, DEEPSETS, ATTENTION, MNIST, CONV],
                         ids=["lrvae", "deepsets", "attention", "mnist", "conv"])
def test_fsdp_specs_match_jax(spec):
    """Every leaf's placement is JAX fsdp_param_specs' on the same
    parameter tree, in the Flax layout, at 2 and 8 shards, with every leaf
    eligible and with the default size floor."""
    model = _model(spec)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}
    params = weights.state_dict_to_variables(model.state_dict())["params"]
    for n_shards, mse in ((2, 0), (8, 0), (2, 2 ** 14), (8, 2 ** 8)):
        port = fsdp_param_specs(shapes, n_shards, mse)
        jspecs = jax_fsdp_param_specs(params, n_shards, mse)
        for n, shape in shapes.items():
            assert port_spec_as_flax(n, port[n], len(shape)) == \
                jax_spec_at(jspecs, n, len(shape)), (n, n_shards, mse)


def test_merge_tp_fsdp_specs():
    shapes = {"qkv": (16, 2, 8), "small": (4,), "plain": (32, 32)}
    tp = {"qkv": (None, "model", None), "small": (), "plain": ()}
    merged = merge_tp_fsdp_specs(shapes, tp, n_data=2, min_shard_elems=0)
    # the TP axis is kept; the largest FREE axis gains 'data'
    assert merged["qkv"] == ("data", "model", None)
    assert merged["small"] == ("data",)
    assert merged["plain"] == (None, "data")   # tie -> minor axis
    merged = merge_tp_fsdp_specs(shapes, tp, n_data=2, min_shard_elems=2 ** 10)
    assert merged["qkv"] == (None, "model", None)
    assert merged["small"] == ()


# ---------------------------------------------------------------- the step


# Bounds on (loss terms, max relative; gradients, relative L2; BatchNorm
# running statistics, max absolute; share of parameter elements apart by
# more than lr/100, the biases before a BatchNorm left out: their
# gradient is roundoff) against the port's single-device step on the same
# weights, global batch and noise. Both sides run the same code: the
# steps differ by where the sums over the batch are cut. Measured (loss,
# gradients, statistics, share): lrvae 1.7e-7, 1.1e-6, 2.4e-7, 0;
# lrvae_pwise 1.6e-6, 2.3e-6, 1.2e-7, 0; deepsets 1.5e-7, 9.8e-7, 6.0e-8,
# 0; attention 6.5e-8, 8.8e-4, none, 1.3e-3 (its decoder's batch-1
# first self-attention takes the cotangent summed over each rank's half
# of the batch and rounds it to bf16 there). Each bound about 10x what
# was measured; a share measured 0 keeps the single-device parity
# bound, 1e-3.
BOUNDS = {"lrvae": (2e-6, 1e-5, 2e-6, 1e-3), "lrvae_pwise": (2e-5, 3e-5, 2e-6, 1e-3),
          "deepsets": (2e-6, 1e-5, 1e-6, 1e-3), "attention": (1e-6, 1e-2, 0.0, 1e-2)}
# Bounds on (loss terms, gradients, share, statistics: sharded_jax_gaps)
# against JAX make_fsdp_train_step: the single-device parity bounds of
# the same models (F32_BOUNDS above for the MLP and DeepSets models, as
# tests/test_torch_deepsets.py; for the attention model
# tests/test_torch_train.py's CPU_F32_BOUNDS: JAX's XLA attention on the
# CPU rounds at other points). Measured: 2.1e-6, 4.7e-6, 0, 2.3e-7
# (lrvae_pwise, the largest of the MLP models); attention 6.5e-8, 8.8e-4,
# 1.5e-3, none.
JAX_BOUNDS = {"lrvae": F32_BOUNDS, "lrvae_pwise": F32_BOUNDS, "deepsets": F32_BOUNDS,
               "attention": (5e-4, 0.05, 0.6, 0.0)}


def _gaps(got, ref):
    m, grads, model = ref
    loss = max(abs(got["metrics"][k] - m[k]) / max(abs(m[k]), 1e-6) for k in m)
    keys = [k for k in grads if not k.endswith("key.bias")]
    assert set(got["grads"]) == set(grads)
    g = (sum(float(((got["grads"][k] - grads[k]) ** 2).sum()) for k in keys)
         / sum(float((grads[k] ** 2).sum()) for k in keys)) ** 0.5
    stats = max((float(np.abs(got["state"][k] - v.numpy()).max())
                 for k, v in model.named_buffers()), default=0.0)
    live = [k for k in keys if k not in pre_batchnorm_biases(list(grads))]
    after = dict(model.named_parameters())
    share = float(np.mean(np.concatenate([
        (np.abs(got["state"][k] - after[k].detach().numpy()) > LR / 100).reshape(-1)
        for k in live])))
    return loss, g, stats, share


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_step_matches_single_device(runs, name):
    """Loss terms, gradients, updated parameters and BatchNorm running
    statistics (in the state) of one FSDP step against one single-device
    step on the global batch, the same on both ranks."""
    got = runs["outs"][0][name]
    gaps = _gaps(got, runs["refs"][name])
    assert all(g <= b for g, b in zip(gaps, BOUNDS[name])), (gaps, BOUNDS[name])
    for k, v in got["state"].items():
        np.testing.assert_array_equal(runs["outs"][1][name]["state"][k], v)


@pytest.mark.parametrize("name", list(STEPS))
def test_fsdp_step_matches_jax(runs, name):
    """The same FSDP steps against JAX make_fsdp_train_step on two virtual
    devices, from the same weights and statistics, on the same global
    batch and noise (min_shard_elems 0 on both sides)."""
    gaps = sharded_jax_gaps(runs["outs"][0][name], runs["jax_refs"][name], LR)
    assert all(g <= b for g, b in zip(gaps, JAX_BOUNDS[name])), (gaps, JAX_BOUNDS[name])


def test_fsdp_starts_from_the_first_ranks_state(runs):
    """Ranks that drew their weights apart (seeded by rank) hold the first
    rank's after fsdp.shard_state: the split leaves and the ones FSDP2
    leaves out alike."""
    want = _model(STEPS["lrvae"]).state_dict()
    for out in runs["outs"]:
        for k, v in want.items():
            np.testing.assert_array_equal(out["replicated"]["state"][k], v.numpy(), err_msg=k)


def test_fsdp_shards_params_and_moments(runs):
    """min_shard_elems 0: every leaf with an even axis holds half of it on
    a rank, its first moment too."""
    got = runs["outs"][0]["lrvae"]
    model = _model(LRVAE)
    split = 0
    for n, p in model.named_parameters():
        local = got["local"][n]
        assert got["mu_local"][n] == local
        if any(d % WORLD == 0 for d in p.shape):
            assert np.prod(local) * WORLD == p.numel(), (n, local)
            split += 1
    assert split > 0


# ---------------------------------------------------------------- the clip


def test_sharded_clip_matches_optax(runs):
    """The clip over the FSDP step's sharded gradients against optax on the
    single-device step's gradients (global norm p = 2, value), and the
    single-device clip for p = 1 and inf (JAX clip_by_global_pnorm)."""
    _, grads, _ = runs["refs"]["lrvae"]
    names = sorted(grads)
    for i, cfg in enumerate(CLIPS):
        got = runs["outs"][0]["clip"]["clipped"][str(i)]
        if cfg["clip_type"] == "value":
            want, _ = optax.clip(cfg["clip_value"]).update(grads, None)
        elif cfg["norm_type"] == 2.0:
            want, _ = optax.clip_by_global_norm(cfg["max_norm"]).update(grads, None)
        else:
            ts = [torch.from_numpy(grads[n].copy()) for n in names]
            make_clip(cfg)(ts)
            want = dict(zip(names, (t.numpy() for t in ts)))
        # the FSDP gradients carry 1.1e-6 of summation order (above); the
        # bias before a BatchNorm has an analytically zero gradient, roundoff
        # on both sides, so the bound is relative to the largest element of
        # the gradients before the clip
        scale = max(float(np.abs(grads[n]).max()) for n in names)
        for n in names:
            np.testing.assert_allclose(got[n], np.asarray(want[n]), rtol=0, atol=1e-5 * scale,
                                       err_msg=f"clip {i} {n}")


# ---------------------------------------------------------------- the trainer


def test_fsdp_trainer_path(runs):
    """fsdp: true trains to a finite loss; the large leaves stay split; only
    rank 0 writes the result tree (one run, one CSV row), and the other
    rank's throwaway directory is gone."""
    got = runs["outs"]
    assert np.isfinite(got[0]["train"]["eval"]["loss"])
    assert got[0]["train"]["result_dir"].startswith(str(runs["tmp"] / "fsdp"))
    assert not os.path.exists(got[1]["train"]["result_dir"])
    runs_dir = glob.glob(str(runs["tmp"] / "fsdp" / "results" / "res_fsdp" / "*"))
    assert len(runs_dir) == 1
    assert sorted(os.listdir(os.path.join(runs_dir[0], "params"))) == [
        "ckpt_0.pkl", "ckpt_1.pkl", "model_1.pkl"]
    with open(glob.glob(str(runs["tmp"] / "fsdp" / "log" / "*"))[0]) as f:
        assert len(f.read().strip().splitlines()) == 2      # header + one row
    assert sharded_fraction(_model(MNIST), WORLD) > 0.5


def test_fsdp_trainer_matches_single_device(runs):
    """Same seed, data and noise: the FSDP run lands on the single-device
    run (eval loss rtol 1e-4; parameters within the update budget of its
    steps, as JAX tests/test_trainer_tp_sp.py:47 bounds TP)."""
    got = runs["outs"][0]["train"]
    np.testing.assert_allclose(got["eval"]["loss"], runs["single"]["eval"]["loss"], rtol=1e-4)
    steps = runs["single_state"].step
    for k, v in runs["single_state"].model.state_dict().items():
        np.testing.assert_allclose(got["state"][k], v.numpy(), atol=steps * TRAIN_LR, rtol=0)


def test_fsdp_resume_replays_continuous_run(runs):
    """Resumed under FSDP from its own ckpt_0.pkl, the run ends where the
    continuous FSDP run ended."""
    got = runs["outs"][0]
    assert got["resume"]["step"] == got["train"]["step"]
    for k, v in got["train"]["state"].items():
        np.testing.assert_allclose(got["resume"]["state"][k], v, rtol=0, atol=1e-6)


def test_fsdp_checkpoint_portable_to_single_device(runs, tmp_path, one_thread):
    """The FSDP run's ckpt_0.pkl (gathered, single-device format) resumes
    on one device and lands on the FSDP run; a single-device ckpt_0.pkl
    resumes under FSDP and lands on the single-device run."""
    (ckpt,) = runs["fsdp_ckpt"]
    state, summary = _single_run(tmp_path, resume_from=ckpt)
    fsdp = runs["outs"][0]
    assert state.step == fsdp["train"]["step"]
    # each trip crosses one strategy boundary for the second epoch's 8
    # steps: bounded by their update budget, as the runs themselves
    # (test_fsdp_trainer_matches_single_device); the eval loss to 1e-4
    budget = 8 * TRAIN_LR
    for k, v in state.model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), fsdp["train"]["state"][k], atol=budget, rtol=0)
    np.testing.assert_allclose(summary["eval"]["loss"], fsdp["train"]["eval"]["loss"], rtol=1e-4)
    back = fsdp["from_single"]
    assert back["step"] == runs["single_state"].step
    for k, v in runs["single_state"].model.state_dict().items():
        np.testing.assert_allclose(back["state"][k], v.numpy(), atol=budget, rtol=0)
    np.testing.assert_allclose(back["eval"]["loss"], runs["single"]["eval"]["loss"], rtol=1e-4)


def test_checkpoint_files_are_single_device_format(runs):
    """An FSDP checkpoint holds whole leaves in the Flax layout: it loads
    into a plain model's state as any single-device one."""
    (ckpt,) = runs["fsdp_ckpt"]
    model = _model(MNIST)
    state = TrainState(model, make_optimizer(model.parameters()))
    _, epoch, extra = checkpoint.load_checkpoint(ckpt, state)
    assert epoch == 0 and "wu_alpha" in extra


# ---------------------------------------------------------------- data parallelism


@pytest.mark.parametrize("kind", ["vae", "lrvae"])
def test_dp_train_step_matches_jax(runs, kind):
    """VanillaVAE (composite) and LRVAE (staged, batch-summed latent-recon
    term, BatchNorm) one DP step against JAX's: loss terms, the reduced
    gradient, the updated parameters, the averaged running statistics;
    both ranks hold the same state."""
    got, want = runs["outs"][0]["dp_" + kind], runs["wants"][kind]
    keys = list(want["params"])
    live = [k for k in keys if k not in pre_batchnorm_biases(keys)]
    rel = max(abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-6)
              for k in want["metrics"])
    gap = grad_gap({k: torch.from_numpy(got["grads"][k]) for k in live}, want["grads"], live)
    share = float(np.mean(np.concatenate([
        (np.abs(got["state"][k] - want["params"][k].numpy()) > LR / 100).reshape(-1)
        for k in live])))
    stats = max_rel(weights.state_dict_to_variables(
        {k: torch.from_numpy(v) for k, v in got["state"].items()})["batch_stats"], want["stats"])
    diffs = (rel, gap, share, stats)
    assert all(d <= b for d, b in zip(diffs, F32_BOUNDS)), (diffs, F32_BOUNDS)
    assert got["count"] == 1
    for k, v in got["state"].items():
        np.testing.assert_array_equal(runs["outs"][1]["dp_" + kind]["state"][k], v)


def test_dp_staged_lrvae_trains_the_latent_term(runs):
    """The staged LRVAE step's latent-recon term is live (JAX
    test_parallel.py:53: lr > 0) and the port's equals JAX's."""
    got, want = runs["outs"][0]["dp_lrvae"], runs["wants"]["lrvae"]
    assert got["metrics"]["lr"] > 0
    np.testing.assert_allclose(got["metrics"]["lr"], want["metrics"]["lr"], rtol=1e-5)


@pytest.mark.parametrize("kind", ["vae", "lrvae"])
def test_dp_eval_step_matches_jax(runs, kind):
    """The DP eval step on the initial state (running statistics; the
    loss terms averaged over the shards) within F32_BOUNDS' first. (After a
    step the biases before each BatchNorm, whose gradient is analytically
    zero, have moved by Adam's lr * sign(roundoff) on each side, which
    the running statistics do not cancel.)"""
    got, want = runs["outs"][0]["dp_" + kind]["eval"], runs["wants"][kind]["eval"]
    for k in want:
        assert abs(got[k] - want[k]) <= F32_BOUNDS[0] * max(abs(want[k]), 1e-6), (k, got, want)


@pytest.mark.parametrize("kind", ["vae", "lrvae"])
def test_dp_pmean_is_mean_of_shard_grads(runs, kind):
    """DDP's reduced gradient equals the mean of the ranks' own
    make_grads_fn gradients of their shards (DDP divides before its
    all-reduce, the mean after: the last bits of a 2-term sum)."""
    got = runs["outs"][0]["dp_" + kind]
    scale = max(float(np.abs(g).max()) for g in got["grads"].values())
    assert got["pmean_gap"] <= 1e-6 * scale


def test_dp_trainer_path(runs):
    """data_parallel on two ranks trains the set model to a finite loss;
    rank 0 alone writes the tree (one run, one CSV row), rank 1's
    throwaway directory is removed; both hold the same parameters."""
    got = runs["outs"]
    assert np.isfinite(got[0]["dp_train"]["eval"]["loss"])
    assert got[0]["dp_train"]["step"] == 2 * 4
    assert not os.path.exists(got[1]["dp_train"]["result_dir"])
    assert len(glob.glob(str(runs["tmp"] / "dp" / "results" / "res_dp" / "*"))) == 1
    with open(glob.glob(str(runs["tmp"] / "dp" / "log" / "*"))[0]) as f:
        assert len(f.read().strip().splitlines()) == 2
    for k, v in got[0]["dp_train"]["state"].items():
        np.testing.assert_array_equal(got[1]["dp_train"]["state"][k], v)


def test_data_parallel_on_one_device_warns_and_runs_single(tmp_path, capsys, one_thread):
    """Without a process group, data_parallel warns and trains
    single-device (JAX train/loop.py:322-332): the same parameters as a
    run without it."""
    kw = dict(DP_TRAIN, epochs=1, device="cpu")
    state, _ = train_and_test(_model(DP_SET), data_parallel=True,
                              output_root=str(tmp_path / "a"), **kw)
    assert "data_parallel requested but only 1 device is visible" in capsys.readouterr().out
    plain, _ = train_and_test(_model(DP_SET), output_root=str(tmp_path / "b"), **kw)
    for (k, a), b in zip(state.model.state_dict().items(), plain.model.state_dict().values()):
        assert torch.equal(a, b), k
