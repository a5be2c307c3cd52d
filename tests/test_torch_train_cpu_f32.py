"""The port's f32 SetVAE and SetLRVAE train steps against JAX
make_train_step on its own CPU path (bf16-rounded attention).
The helpers and bounds are tests/test_torch_train.py's (its docstring
says how the JAX side runs); the cases sit in files of their own so that
pytest-xdist's --dist loadfile spreads them over its workers."""

import pytest

from test_torch_train import CPU_BF16_BOUNDS, CPU_F32_BOUNDS, _assert_within, _train_diffs


@pytest.mark.parametrize("kind,mixed", [("setvae", False), ("setlrvae", False)])
def test_train_step_matches_jax_cpu_path(monkeypatch, kind, mixed):
    _assert_within(_train_diffs(monkeypatch, kind, mixed),
                   CPU_BF16_BOUNDS if mixed else CPU_F32_BOUNDS)
