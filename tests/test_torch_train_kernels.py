"""The port's SetVAE and SetLRVAE train steps against JAX make_train_step
with its Pallas kernels in interpret mode (the staged gradient mode:
tests/test_torch_train_staged.py).
The helpers and bounds are tests/test_torch_train.py's (its docstring
says how the JAX side runs); the cases sit in files of their own so that
pytest-xdist's --dist loadfile spreads them over its workers."""

import pytest

from test_torch_train import KERNEL_BOUNDS, _assert_within, _patch_jax_kernels, _train_diffs


@pytest.mark.parametrize("kind", ["setvae", "setlrvae"])
def test_train_step_matches_jax_kernels_interpret(monkeypatch, kind):
    _patch_jax_kernels(monkeypatch)
    _assert_within(_train_diffs(monkeypatch, kind, False), KERNEL_BOUNDS)
