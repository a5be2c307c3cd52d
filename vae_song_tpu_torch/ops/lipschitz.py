"""Empirical local-Lipschitz estimate (port of
vae_song_tpu/ops/lipschitz.py; the reference's utils.py:532-567): random
index pairs of the samples X, the ratios ||f(x1) - f(x2)|| / ||x1 - x2||,
and their quantiles, in one batch:

    inv_lips = 1 / quantile(ratios, q)
    lips     = quantile(ratios, 1 - q)
    bi_lips  = max(inv_lips, lips)
"""

from vae_song_tpu_torch.analysis import _quantile_ratios, _randint


def estimate_local_lipschitz(func, X, generator=None, num_pairs: int = 2000, metric: int = 2,
                             quantile: float = 0.05, eps: float = 1e-3, idx1=None, idx2=None):
    """(inverse_lipschitz, lipschitz, bi_lipschitz) floats; the pairs are
    idx1, idx2 [num_pairs] in [0, n), drawn from `generator` (CPU) unless
    given. Shares the quantile arithmetic with the cell fields
    (analysis._quantile_ratios), as the JAX package does."""
    n = X.shape[0]
    if n < 2:
        return 0.0, 0.0, 0.0
    if metric != 2:
        raise NotImplementedError("only the L2 metric is supported")
    if idx1 is None:
        idx1 = _randint(generator, n, (num_pairs,), X.device)
        idx2 = _randint(generator, n, (num_pairs,), X.device)
    x1, x2 = X[idx1.to(X.device).long()], X[idx2.to(X.device).long()]
    inv_a, b, bi = _quantile_ratios(func(x1)[None], func(x2)[None], x1[None], x2[None],
                                    quantile, eps)
    return float(inv_a[0]), float(b[0]), float(bi[0])
