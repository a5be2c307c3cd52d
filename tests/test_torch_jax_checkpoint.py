"""A JAX trainer checkpoint (`ckpt_*.pkl`: flax msgpack bytes of the
TrainState beside the epoch and `extra`) resumed by the port: the
msgpack reader in vae_song_tpu_torch/train/checkpoint.py against flax's
own, and the port's next step from a JAX checkpoint against JAX's next
step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from vae_song_tpu.models import build_model as jax_build_model
from vae_song_tpu.train import checkpoint as jax_ckpt
from vae_song_tpu.train import state as jax_state
from vae_song_tpu.train.steps import make_train_step as jax_make_train_step
from vae_song_tpu_torch import weights
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
from vae_song_tpu_torch.train import checkpoint
from vae_song_tpu_torch.train.loop import train_and_test
from vae_song_tpu_torch.train.state import TrainState, adam_state, make_optimizer
from vae_song_tpu_torch.train.steps import make_train_step

from jax_parity import one_thread, patch_eps, to_np  # noqa: F401

# one torch thread a test: pytest-xdist runs six processes on the same cores
pytestmark = pytest.mark.usefixtures("one_thread")


def _same(got, want):
    """Equal trees: the same keys, types and values (arrays bitwise)."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys()
        for k in want:
            _same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and (got == want or (got != got and want != want))


_RNG = np.random.default_rng(0)
# each msgpack family flax writes: fixmap, map16 (16+ keys), map32 (65536+);
# fixstr, str8, str16; bin8, bin16, bin32; every int width and sign; f32
# arrays as ext 1 and numpy scalars as ext 3 (fixext and ext8/16/32
# lengths); float64 numbers; nil, booleans, arrays.
TREES = {
    "fixmap": {"a": 1, "b": -1, "c": 0.5},
    "map16": {str(i): np.float32(i) for i in range(300)},
    "map32": {str(i): i for i in range(70000)},
    "strings": {"s": "x" * 20, "m": "y" * 200, "l": "z" * 70000},
    "bins": {"b8": b"\x01" * 10, "b16": b"\x02" * 300, "b32": bytes(70000)},
    "ints": {"v": [0, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63, -1, -32, -33, -128,
                   -129, -32768, -32769, -2**31 - 1, -2**63]},
    "floats": {"v": [0.1, -1e300, float("inf")], "nan": float("nan")},
    "misc": {"n": None, "t": True, "f": False, "l": [1, [2, "3"]]},
    "ndarrays": {"f32": _RNG.normal(size=(3, 5)).astype(np.float32),
                 "i32": np.arange(7, dtype=np.int32), "scalar": np.zeros((), np.int32),
                 "big": _RNG.normal(size=(200, 300)).astype(np.float32),
                 "f64": _RNG.normal(size=(2,)), "u8": np.arange(3, dtype=np.uint8)},
    "npscalars": {"i": np.int32(-4), "f": np.float32(2.5), "d": np.float64(1e-3)},
}


@pytest.mark.parametrize("name", list(TREES))
def test_msgpack_restore_matches_flax(name):
    data = serialization.msgpack_serialize(TREES[name])
    _same(checkpoint.msgpack_restore(data), serialization.msgpack_restore(data))


def test_msgpack_restore_joins_chunked_arrays(monkeypatch):
    """flax splits arrays past MAX_CHUNK_SIZE bytes (1 GiB) into chunks;
    with the size made small here, the reader puts them back together."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    tree = {"w": _RNG.normal(size=(10, 7)).astype(np.float32), "n": {"x": np.arange(40.0)}}
    data = serialization.msgpack_serialize(tree)
    got = checkpoint.msgpack_restore(data)
    _same(got, serialization.msgpack_restore(data))
    _same(got, tree)


N, LATENT, B, BETA, ALPHA, WU_ALPHA, LR = 64, 16, 8, 0.001, 0.5, 0.3, 1e-2
CLIP = {"enabled": True, "clip_type": "norm", "max_norm": 1.0}
DEEPSETS = dict(latent_channel=LATENT, num_points=N, use_attention=False,
                encoder_hidden=[32, 64], decoder_hidden=[64, 32])
ATTN = dict(latent_channel=LATENT, num_points=N, d_model=64, num_heads=2,
            num_encoder_layers=1, num_decoder_layers=1, ff_dim=32)


def _data(seed):
    rng = np.random.default_rng(seed)
    return ((rng.normal(size=(B, N, 3)) * 0.5).astype(np.float32),
            rng.normal(size=(B, LATENT)).astype(np.float32))


def _jax_checkpoint(monkeypatch, tmp_path, kind, mp):
    """A JAX TrainState (global-norm clip, cosine schedule) after one step,
    written by JAX's save_checkpoint as `ckpt_1.pkl`; returns (path, JAX
    model, optimizer, state) and the port model with other weights."""
    port = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA,
                       generator=torch.Generator().manual_seed(0))
    variables = weights.state_dict_to_variables(port.state_dict())
    jmodel = jax_build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA)
    tx = jax_state.make_optimizer(lr=LR, total_steps=10, grad_clip=CLIP)
    state = jax_state.TrainState.create(jax.tree.map(jnp.asarray, variables["params"]),
                                        jax.tree.map(jnp.asarray, variables["batch_stats"]), tx)
    x, eps = _data(10)
    patch_eps(monkeypatch, eps)
    state = jax_make_train_step(jmodel, tx)(state, jnp.asarray(x), WU_ALPHA,
                                            jax.random.PRNGKey(0))[0]
    path = str(tmp_path / "ckpt_1.pkl")
    jax_ckpt.save_checkpoint(path, state, epoch=1, extra={"wu_alpha": 0.25, "last_kl": 1.5})
    other = build_model(kind, "shapenet", mp, beta=BETA, alpha=ALPHA,
                        generator=torch.Generator().manual_seed(1))
    return path, jmodel, tx, state, other


# (kind, model params, bound on the moments and parameters after the next
# step relative to each one's max): DeepSets SetVAE, f32, the bound of
# tests/test_torch_trainer_options.py::test_jax_train_state_carries_across
# (measured 1.7e-5 here); the attention SetLRVAE, f32, where JAX's CPU
# attention rounds q, k, v and P to bf16 and its backward differs from the
# port's by that rounding (tests/test_torch_train.py): 2e-3 (measured
# 1.3e-4).
CASES = {"deepsets": ("setvae", DEEPSETS, 5e-5), "attention": ("setlrvae", ATTN, 2e-3)}


@pytest.mark.parametrize("case", list(CASES))
def test_port_resumes_a_jax_checkpoint(monkeypatch, tmp_path, case):
    """The port's load_checkpoint reads the JAX file: parameters,
    statistics, Adam's moments, count and step bitwise, the epoch and
    `extra`; then one more step in each package on the same clouds and
    noise lands within the case's bound (the pre-BatchNorm biases, whose
    gradient is roundoff, within 2 lr)."""
    kind, mp, bound = CASES[case]
    path, jmodel, tx, state, port = _jax_checkpoint(monkeypatch, tmp_path, kind, mp)
    ts = TrainState(port, make_optimizer(port.parameters(), lr=LR, total_steps=10,
                                         grad_clip=CLIP))
    ts, epoch, extra = checkpoint.load_checkpoint(path, ts)
    assert (epoch, extra) == (1, {"wu_alpha": 0.25, "last_kl": 1.5})
    assert ts.step == 1 and ts.optimizer.count == 1
    keys = [k for k, _ in port.named_parameters()]
    opt = to_np(serialization.to_state_dict(state.opt_state))["1"]["0"]
    for name in ("mu", "nu"):
        want = weights.params_to_state_dict(opt[name], keys)
        for k, v in adam_state(ts)[name].items():
            assert torch.equal(v, want[k]), (name, k)
    want = weights.params_to_state_dict(to_np(state.params), port.state_dict().keys(),
                                        to_np(state.batch_stats))
    for k, v in port.state_dict().items():
        assert torch.equal(v, want[k]), k

    x, eps = _data(12)
    monkeypatch.undo()
    patch_eps(monkeypatch, eps)
    state = jax_make_train_step(jmodel, tx)(state, jnp.asarray(x), WU_ALPHA,
                                            jax.random.PRNGKey(2))[0]
    make_train_step(port, ts.optimizer)(torch.from_numpy(x), torch.from_numpy(eps), WU_ALPHA)
    after = to_np(serialization.to_state_dict(state.opt_state))["1"]["0"]
    skip = pre_batchnorm_biases(keys)
    worst = 0.0
    for name, want_tree, got in (("mu", after["mu"], adam_state(ts)["mu"]),
                                 ("nu", after["nu"], adam_state(ts)["nu"]),
                                 ("params", to_np(state.params), dict(port.named_parameters()))):
        want = weights.params_to_state_dict(want_tree, keys)
        for k in keys:
            err = float((got[k].detach() - want[k]).abs().max())
            if k in skip or k.endswith("key.bias"):
                assert name != "params" or err <= 2 * LR, (name, k, err)
            else:
                worst = max(worst, err / max(1e-12, float(want[k].abs().max())))
    assert worst <= bound, worst
    assert ts.optimizer.count == int(after["count"]) == 2


def test_train_and_test_resumes_a_jax_checkpoint(monkeypatch, tmp_path):
    """`train_and_test(resume_from=<JAX ckpt_1.pkl>)` continues at epoch 2
    from the JAX state after its one step (one epoch of 2 steps here) and
    finishes."""
    path, _, _, _, port = _jax_checkpoint(monkeypatch, tmp_path, "setvae", DEEPSETS)
    state, summary = train_and_test(
        port, epochs=3, batch_size=B, dataset_name="shapenet", seed=5, lr=LR, grad_clip=CLIP,
        device="cpu", dataset_params={"fake": True, "num_points": N, "num_samples": 16,
                                      "num_test_samples": 8},
        output_root=str(tmp_path / "out"), resume_from=path, visualize_artifacts=False,
        progress=False)
    assert state.step == 1 + 2 and state.optimizer.count == 3
    assert np.isfinite(summary["eval"]["loss"])
