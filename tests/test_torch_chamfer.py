"""The port's Chamfer forward (vae_song_tpu_torch/ops/chamfer.py) against
the JAX package: the plain packed-key version against the Pallas kernel
`_chamfer_pallas_fwd_impl` in interpret mode (bitwise: both compute
d2 = ((dx*dx) + (dy*dy)) + (dz*dz) in f32; the port without FMA, XLA's
CPU code with FMA contraction allowed, which these inputs do not reach
through the 11 truncated bits or which their grid makes exact), and the
tiled `chamfer_distance` against its JAX counterpart."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vae_song_tpu.ops import chamfer as jax_chamfer
from vae_song_tpu_torch.ops import chamfer

VAL_RTOL = 2.0 ** -12  # packed truncation of the min value


def _clouds(b, np_, ng, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, np_, 3)).astype(np.float32),
            rng.normal(size=(b, ng, 3)).astype(np.float32))


GRID = 2.0 ** -9


def _collapsed_clouds(b, np_, ng, seed):
    """pred concentrated on 4 points of each cloud plus noise of up to 2
    steps of 2^-9 (about 1e-3): exact and near ties between pred points in
    different pred tiles. Both clouds lie on the 2^-9 grid within [-1.51,
    1.51], so every d2 is a multiple of 2^-18 below 48 and exact in f32:
    XLA's CPU backend always allows FMA contraction, which on other inputs
    moves a d2 by one rounding (measured with 1e-3 normal noise at these
    shapes: one minp of 4096 one truncation step apart)."""
    rng = np.random.default_rng(seed)
    on_grid = lambda x: (np.round(np.clip(x, -1.5, 1.5) / GRID) * GRID).astype(np.float32)
    centres = on_grid(rng.normal(size=(b, 4, 3)))
    pred = centres[:, np.arange(np_) % 4] + GRID * rng.integers(-2, 3, size=(b, np_, 3))
    return pred.astype(np.float32), on_grid(rng.normal(size=(b, ng, 3)))


@pytest.mark.parametrize("np_,ng,tile,collapsed", [
    pytest.param(128, 128, 128, False, id="128-128-128"),
    pytest.param(256, 128, 128, False, id="256-128-128"),
    pytest.param(128, 256, 64, False, id="128-256-64"),
    pytest.param(512, 256, 128, True, id="512-256-128-collapsed"),
])
def test_plain_matches_pallas_bitwise(np_, ng, tile, collapsed):
    if collapsed:
        pred, gt = _collapsed_clouds(8, np_, ng, seed=np_ + ng)
        assert len(np.unique(pred[0], axis=0)) < np_          # repeated points: exact ties
    else:
        pred, gt = _clouds(8, np_, ng, seed=np_ + ng)
    want = jax_chamfer._chamfer_pallas_fwd_impl(jnp.asarray(pred), jnp.asarray(gt), tile,
                                                interpret=True)
    got = chamfer.chamfer_nn_packed(torch.from_numpy(pred), torch.from_numpy(gt))
    for name, w, g in zip(("minp", "argp", "ming", "argg"), want, got):
        w = np.asarray(w)
        assert g.dtype == (torch.float32 if w.dtype == np.float32 else torch.int32)
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)


def test_exact_ties_pick_first():
    """Duplicate gt points tie exactly; the lower index wins and an exact
    zero survives packing (tests/test_chamfer_fwd_kernel.py:49)."""
    rng = np.random.default_rng(1)
    gt = rng.normal(size=(8, 16, 3)).astype(np.float32)
    gt[:, 9] = gt[:, 3]
    pred = rng.normal(size=(8, 16, 3)).astype(np.float32)
    pred[:, 5] = gt[:, 3]
    minp, argp, _, _ = chamfer.chamfer_nn_packed(torch.from_numpy(pred), torch.from_numpy(gt))
    assert (argp[:, 5] == 3).all()
    assert (minp[:, 5] == 0.0).all()


@pytest.mark.parametrize("n", [96, 1100])  # dense and tiled branches
def test_chamfer_distance_matches_jax(n):
    pred, gt = _clouds(2, n, n + 32, seed=n)
    want = float(jax_chamfer.chamfer_distance(jnp.asarray(pred), jnp.asarray(gt)))
    got = float(chamfer.chamfer_distance(torch.from_numpy(pred), torch.from_numpy(gt)))
    # f32 matmul expansion on both sides, different summation order
    assert got == pytest.approx(want, rel=1e-5)


def test_packed_scalar_within_truncation_of_chamfer_distance():
    pred, gt = _clouds(8, 128, 128, seed=2)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    minp, _, ming, _ = chamfer.chamfer_nn_packed(p, g)
    packed = float((minp.mean(dim=1) + ming.mean(dim=1)).mean())
    exact = float(chamfer.chamfer_distance(p, g))
    # truncation only lowers the value, by <= 2^-12 relative; the
    # expansion in chamfer_distance adds f32 roundoff on top
    assert packed == pytest.approx(exact, rel=VAL_RTOL)
    assert packed <= exact * (1 + 1e-6)


def test_best_chamfer_on_cpu_is_the_tiled_path():
    pred, gt = _clouds(2, 128, 128, seed=4)
    p, g = torch.from_numpy(pred), torch.from_numpy(gt)
    before = chamfer.chamfer_nn_packed.launches
    assert float(chamfer.best_chamfer(p, g)) == float(chamfer.chamfer_distance(p, g))
    chamfer.chamfer_nn_packed(p, g)
    assert chamfer.chamfer_nn_packed.launches == before


def test_packed_n_guard():
    assert chamfer.MAX_PACKED_N == jax_chamfer.MAX_PACKED_N == 2048
    small = torch.zeros(1, 16, 3)
    with pytest.raises(ValueError):
        chamfer.chamfer_nn_packed(torch.zeros(1, 2049, 3), small)
    with pytest.raises(ValueError):
        chamfer.chamfer_nn_packed(small, torch.zeros(1, 2049, 3))
    with pytest.raises(TypeError):
        chamfer.chamfer_nn_packed(small.double(), small.double())


@pytest.mark.parametrize("b", [64, 16, 12, 4, 1])
@pytest.mark.parametrize("np_,ng", [(2048, 2048), (2000, 2048), (2048, 1920), (128, 256),
                                    (4096, 2048), (2176, 128)])
def test_packed_gate_matches_jax_choice(monkeypatch, b, np_, ng):
    """`packed_chamfer_ok` against the choice the JAX `best_chamfer` makes on
    a TPU backend (batch a multiple of 8, both clouds multiples of 128, at
    most 2048 points), seen by answering its backend check with "tpu" and
    recording whether it calls its Pallas path."""
    import jax

    chose = []
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jax_chamfer, "chamfer_distance_pallas",
                        lambda *a: chose.append(True) or jnp.float32(0.0))
    monkeypatch.setattr(jax_chamfer, "chamfer_distance", lambda *a: jnp.float32(0.0))
    jax_chamfer.best_chamfer(jnp.zeros((b, np_, 3)), jnp.zeros((b, ng, 3)))
    assert chamfer.packed_chamfer_ok(b, np_, ng) == bool(chose)
