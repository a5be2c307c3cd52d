"""The port's SetLRVAE train step under the staged gradient mode against
JAX make_train_step with its Pallas kernels in interpret mode. The
helpers and bounds are tests/test_torch_train.py's (its docstring says
how the JAX side runs); the case sits in a file of its own so that
pytest-xdist's --dist loadfile spreads it over its workers."""

from test_torch_train import KERNEL_BOUNDS, _assert_within, _patch_jax_kernels, _train_diffs


def test_staged_grad_mode_matches_jax(monkeypatch):
    """SetLRVAE under grad_mode="staged" (g_main + g_lr with the encoder's
    share of g_lr scaled by 1e-4) against JAX make_train_step(...,
    grad_mode="staged"), the JAX kernels in interpret mode: within
    KERNEL_BOUNDS (measured 2.8e-7, 3.3e-6, 1.5e-6, 3.2e-5, 1.5e-4,
    4.7e-6)."""
    _patch_jax_kernels(monkeypatch)
    _assert_within(_train_diffs(monkeypatch, "setlrvae", False, grad_mode="staged"),
                   KERNEL_BOUNDS)
