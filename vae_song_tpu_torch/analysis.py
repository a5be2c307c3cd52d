"""Lipschitz / KL field analysis (port of vae_song_tpu/analysis.py; the
reference's lipschitz.py:48-222).

As in the JAX package, each field is a few batched calls instead of the
reference's per-cell loops:

  * per-cell KL over X-space: one encode of the whole set and one segment
    mean (`index_add_`);
  * per-cell decoder Lipschitz: `num_pairs` index pairs a cell gathered
    into one [cells * pairs, zdim] decode batch a side;
  * the Z-space grid: a dense [K_z^2, nsamples, 2] tensor of jittered cell
    centres, decoded and re-encoded in one batch.

Randomness: a function that draws takes a torch.Generator (CPU; the draws
are moved to the data's device, so a run does not depend on it) or the
draws themselves (index pairs, eps, a permutation), so tests hand the
port the numbers the JAX package drew. `gather_cell_samples` draws on the
host with numpy from an int seed, as JAX does. The decode and encode
functions are the model's under `torch.no_grad()` (train/steps.py:
make_apply_fns); LIDVAE's decode takes its gradient inside.
"""

import numpy as np
import torch

from vae_song_tpu_torch.ops import losses

DEFAULT_EMPTY_CELL_FILL_VALUE = -5.0  # lipschitz.py:19


def _randint(generator, high, shape, device):
    return torch.randint(0, high, shape, generator=generator).to(device)


def _quantile_ratios(y1, y2, x1, x2, quantile=0.05, eps=1e-3):
    """(inv_lips, lips, bi_lips) per group from pair ratios; y*, x*:
    [G, P, D...], G groups of P pairs. Quantiles interpolate linearly, as
    jnp.quantile's default."""
    g, p = x1.shape[0], x1.shape[1]
    dy = torch.linalg.vector_norm((y1 - y2).reshape(g, p, -1), dim=-1).clamp(min=eps)
    dx = torch.linalg.vector_norm((x1 - x2).reshape(g, p, -1), dim=-1).clamp(min=eps)
    ratio = dy / dx
    a = torch.quantile(ratio, quantile, dim=1).clamp(min=eps)
    b = torch.quantile(ratio, 1.0 - quantile, dim=1)
    inv_a = 1.0 / a
    return inv_a, b, torch.maximum(inv_a, b)


def per_cell_kl(mu, log_var, labels, num_cells, fill=DEFAULT_EMPTY_CELL_FILL_VALUE):
    """(mean per-sample KL of each cell, `fill` where a cell is empty;
    the member counts) (lipschitz.py:61-63)."""
    kl = losses.kl_per_sample(mu, log_var)
    labels = labels.to(kl.device).long()
    sums = torch.zeros(num_cells, dtype=kl.dtype, device=kl.device).index_add_(0, labels, kl)
    counts = torch.zeros(num_cells, dtype=kl.dtype, device=kl.device).index_add_(
        0, labels, torch.ones_like(kl))
    means = torch.where(counts > 0, sums / counts.clamp(min=1), torch.full_like(sums, fill))
    return means, counts


def cellwise_decoder_lipschitz(decode_fn, z_by_cell, valid, generator=None, num_pairs: int = 2000,
                               quantile: float = 0.05, eps: float = 1e-3,
                               fill: float = DEFAULT_EMPTY_CELL_FILL_VALUE, idx1=None, idx2=None):
    """Per-cell decoder Lipschitz statistics in one decode batch a side.

    z_by_cell [C, S, zdim]: fixed-size z samples a cell (rows of invalid
    cells may hold anything); valid [C] bool: cells with >= 2 members.
    The pairs are idx1, idx2 [C, num_pairs] in [0, S), drawn from
    `generator` unless given. Returns (inv_lips, lips, bi_lips), each [C],
    `fill` where a cell is invalid."""
    c, s, zdim = z_by_cell.shape
    dev = z_by_cell.device
    if idx1 is None:
        idx1 = _randint(generator, s, (c, num_pairs), dev)
        idx2 = _randint(generator, s, (c, num_pairs), dev)
    idx1, idx2 = idx1.to(dev).long(), idx2.to(dev).long()
    num_pairs = idx1.shape[1]
    z1 = torch.gather(z_by_cell, 1, idx1[..., None].expand(-1, -1, zdim))
    z2 = torch.gather(z_by_cell, 1, idx2[..., None].expand(-1, -1, zdim))
    y1 = decode_fn(z1.reshape(c * num_pairs, zdim)).reshape(c, num_pairs, -1)
    y2 = decode_fn(z2.reshape(c * num_pairs, zdim)).reshape(c, num_pairs, -1)
    valid = valid.to(dev)
    return tuple(torch.where(valid, v, torch.full_like(v, fill))
                 for v in _quantile_ratios(y1, y2, z1, z2, quantile, eps))


def gather_cell_samples(mu, log_var, labels, num_cells, seed: int, samples_per_cell: int = 256,
                        device=None):
    """Host-side preparation: for each cell, `samples_per_cell` member
    indices drawn with replacement and one reparameterisation each ->
    (z [C, S, zdim] float32, valid [C] bool, counts [C] numpy int64), the
    tensors on `device`. numpy's default_rng(seed) draws, in JAX's order,
    so the same int seed gives JAX's samples bit for bit (JAX takes the
    seed from its key)."""
    mu = mu.detach().cpu().numpy() if isinstance(mu, torch.Tensor) else np.asarray(mu)
    log_var = (log_var.detach().cpu().numpy() if isinstance(log_var, torch.Tensor)
               else np.asarray(log_var))
    labels = np.asarray(labels.cpu() if isinstance(labels, torch.Tensor) else labels)
    c, zdim = num_cells, mu.shape[1]
    rng = np.random.default_rng(int(seed))
    member_idx = np.zeros((c, samples_per_cell), np.int32)
    valid = np.zeros(c, bool)
    counts = np.zeros(c, np.int64)
    for cell in range(c):
        members = np.nonzero(labels == cell)[0]
        counts[cell] = len(members)
        if len(members) >= 2:
            valid[cell] = True
            member_idx[cell] = rng.choice(members, samples_per_cell, replace=True)
    mu_s = mu[member_idx]
    std_s = np.exp(0.5 * log_var[member_idx])
    eps = rng.standard_normal((c, samples_per_cell, zdim)).astype(np.float32)
    z = (mu_s + eps * std_s).astype(np.float32)
    return torch.from_numpy(z).to(device), torch.from_numpy(valid).to(device), counts


def z_grid_samples(K_z, z_min, z_max, latent_dim, generator=None, nsamples_per_cell=100,
                   jitter_std=0.1, eps=None, device=None):
    """[K_z^2, n, latent_dim] jittered Z-grid samples (lipschitz.py:100-115),
    cell index = y_idx * K_z + x_idx as in the reference; eps [K_z^2, n, 2]
    drawn from `generator` unless given."""
    if latent_dim != 2:
        raise ValueError(
            f"Skipping Z-space grid evaluation: Model's actual latent "
            f"dimension is {latent_dim}D, not 2D."
        )
    zx = np.linspace(z_min, z_max, K_z)
    zy = np.linspace(z_min, z_max, K_z)
    centers = np.array([[zx[xi], zy[yi]] for yi in range(K_z) for xi in range(K_z)], np.float32)
    if eps is None:
        eps = torch.randn(K_z * K_z, nsamples_per_cell, latent_dim, generator=generator)
    return torch.from_numpy(centers).to(device)[:, None, :] + jitter_std * eps.to(device)


def z_grid_kl(decode_fn, encode_fn, z_samples):
    """Decode each Z-grid sample, re-encode it, and average KL(re-encoding
    || N(0, I)) over each cell (lipschitz.py:117-133), in one batch."""
    c, n, zdim = z_samples.shape
    mu_re, log_var_re = encode_fn(decode_fn(z_samples.reshape(c * n, zdim)))
    return losses.kl_per_sample(mu_re, log_var_re).reshape(c, n).mean(dim=1)


def data_based_z_samples(mu, log_var, generator=None, num_samples=5000, eps=None, perm=None):
    """(z samples of the encoded data distribution, the mu and log_var
    subset used) (lipschitz.py:157-222). With fewer than `num_samples`
    points every point gets num_samples // n + 1 draws (eps [n, ns, zdim]);
    else a random subset (perm: a permutation of n, its first
    num_samples taken; eps [num_samples, zdim]). The draws come from
    `generator` unless given."""
    n, zdim = mu.shape
    dev = mu.device
    if n < num_samples:
        if eps is None:
            eps = torch.randn(n, num_samples // n + 1, zdim, generator=generator)
        z = mu[:, None, :] + eps.to(dev) * torch.exp(0.5 * log_var)[:, None, :]
        return z.reshape(-1, zdim)[:num_samples], mu, log_var
    if perm is None:
        perm = torch.randperm(n, generator=generator)
        eps = torch.randn(num_samples, zdim, generator=generator)
    idx = perm.to(dev).long()[:num_samples]
    mu_s, lv_s = mu[idx], log_var[idx]
    return mu_s + eps.to(dev) * torch.exp(0.5 * lv_s), mu_s, lv_s


def data_based_kl(mu_subset, log_var_subset):
    """Mean per-sample KL over the data-based subset (lipschitz.py:219-220)."""
    return float(losses.kl_per_sample(mu_subset, log_var_subset).mean())


def compute_local_reg(loss_fn, X, labels, K):
    """Per-grid-cell mean of the VAE regulariser (utils.py:509-530):
    loss_fn(x_cell, a CPU tensor) -> the scalar regulariser of that batch,
    divided by the cell's size; 0 for an empty cell."""
    X = np.asarray(X)
    labels = np.asarray(labels)
    regs = []
    for cell in range(K * K):
        mask = labels == cell
        if mask.sum() == 0:
            regs.append(0.0)
            continue
        x_cell = X[mask]
        regs.append(float(loss_fn(torch.from_numpy(x_cell))) / x_cell.shape[0])
    return np.array(regs)


def data_based_lipschitz(decode_fn, z_samples, generator=None, num_pairs=5000, quantile=0.05,
                         eps=1e-3, i1=None, i2=None):
    """Global decoder (inv_lips, lips, bi_lips) from data-distribution z
    samples: i1, i2 [num_pairs] in [0, n), drawn unless given."""
    n, dev = z_samples.shape[0], z_samples.device
    if i1 is None:
        i1 = _randint(generator, n, (num_pairs,), dev)
        i2 = _randint(generator, n, (num_pairs,), dev)
    z1, z2 = z_samples[i1.to(dev).long()], z_samples[i2.to(dev).long()]
    inv_a, b, bi = _quantile_ratios(decode_fn(z1)[None], decode_fn(z2)[None], z1[None], z2[None],
                                    quantile, eps)
    return float(inv_a[0]), float(b[0]), float(bi[0])
