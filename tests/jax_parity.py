"""Helpers shared by the tests that hold the PyTorch port to the JAX
package on the CPU (tests/test_torch_*.py). Not a test module."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch


@pytest.fixture
def one_thread():
    """One intra-op torch thread for the test: under pytest-xdist's workers
    every process would otherwise run 8 OpenMP threads on the same cores,
    and a small model's training then spends most of its time waiting at
    thread barriers (a 16-step fake-MNIST run: 3.6 s alone, 60 s beside 7
    busy processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def to_np(tree):
    """A JAX tree as writable float32 numpy arrays."""
    return jax.tree.map(lambda a: np.array(a, dtype=np.float32), tree)


def grads_capture():
    """A gradient transformation that passes its input through and keeps
    it as its state: chained before the optimizer, the jitted JAX train
    step hands back the gradient it computed in `opt_state[0]`."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates),
    )


def patch_eps(monkeypatch, eps):
    """jax.random.normal returns `eps` for draws of its shape (the
    reparameterisation noise), so JAX uses the noise the port is given.
    A jitted step keeps the eps it was traced with."""
    normal = jax.random.normal
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32: (
        jnp.asarray(eps, dtype) if tuple(shape) == eps.shape else normal(key, shape, dtype)))


# ---------------------------------------------------------------- the FlexibleVAE family

# Small configurations of each encoder/decoder pair, by name: (dataset,
# model_params). Three hidden blocks of width 8; MNIST's 28 x 28 x 1
# geometry for the image models (the conv pyramid 28 -> 4 -> 28).
FLEX_ARCHS = {
    "mlp1d": ("pinwheel", dict(encoder_type="mlp", decoder_type="mlp", hchans=[8, 8, 8])),
    "mlp1d-res": ("pinwheel", dict(encoder_type="mlp", decoder_type="mlp", hchans=[8, 8, 8],
                                   residual_connection=True)),
    "mlp2d": ("mnist", dict(encoder_type="mlp", decoder_type="mlp", hchans=[8, 8, 8])),
    "conv-mlp": ("mnist", dict(encoder_type="conv", decoder_type="mlp", hchans=[8, 8, 8])),
    "conv-conv": ("mnist", dict(encoder_type="conv", decoder_type="conv", hchans=[8, 8, 8])),
}


def random_stats(bs, seed):
    """BatchNorm running statistics away from their initial 0 / 1."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.random(a.shape) + 0.5 if path[-1].key == "var"
                         else rng.normal(size=a.shape)).astype(np.float32), to_np(bs))


def flex_inputs(arch, batch, seed=0):
    """Inputs of `arch`'s dataset: pinwheel points, or [0, 1) images NHWC."""
    rng = np.random.default_rng(seed)
    if FLEX_ARCHS[arch][0] == "pinwheel":
        from vae_song_tpu_torch.data.synthetic import generate_spin_data
        return generate_spin_data(batch * 5, rng=rng)[0][:batch]
    return rng.random((batch, 28, 28, 1)).astype(np.float32)


def flex_pair(kind, arch, mixed=False, beta=0.01, alpha=0.5, extra=None, seed=0):
    """The JAX model of `kind` ("vae", "nae", "lrvae") and `arch` with its
    initial variables (running statistics made random), and the port model
    holding the same."""
    from vae_song_tpu.models import build_model as jax_build_model
    from vae_song_tpu.train.loop import init_model
    from vae_song_tpu_torch import weights
    from vae_song_tpu_torch.models.registry import build_model

    dataset, mp = FLEX_ARCHS[arch]
    mp = dict(mp, mixed_precision=mixed, **(extra or {}))
    jmodel = jax_build_model(kind, dataset, mp, beta=beta, alpha=alpha)
    params, bs = init_model(jmodel, flex_inputs(arch, 2), seed=seed)
    params, bs = to_np(params), random_stats(bs, seed + 1)
    port = build_model(kind, dataset, mp, beta=beta, alpha=alpha)
    weights.load_flax_params(port, params, bs)
    return jmodel, params, bs, port


def rel_err(got, want):
    """max|got - want| / max(1, max|want|) of a tensor or array against an
    array of the same shape."""
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def max_rel(got_tree, want_tree):
    """Largest |got - want| / max(1, max|want|) over matching leaves."""
    got = dict(jax.tree_util.tree_flatten_with_path(to_np(got_tree))[0])
    want = dict(jax.tree_util.tree_flatten_with_path(to_np(want_tree))[0])
    assert got.keys() == want.keys()
    return max(float(np.abs(got[k] - want[k]).max()) / max(1.0, float(np.abs(want[k]).max()))
               for k in want)


def grad_gap(a, b, keys):
    """Relative L2 distance of gradient dict `a` from `b` over `keys`."""
    num = sum(float(((a[k] - b[k]) ** 2).sum()) for k in keys)
    return (num / sum(float((b[k] ** 2).sum()) for k in keys)) ** 0.5


def flex_step_parity(monkeypatch, kind, arch, mixed, n_samples, extra=None, n_micro=1,
                     batch=16, eager=False, lr=1e-2, wu_alpha=0.3, alpha=0.5):
    """One train step of the JAX package (make_train_step, or
    make_accum_train_step at n_micro > 1; with `eager` under
    jax.disable_jit, so each op rounds as Flax declares) and of the port
    from the same weights, statistics, inputs and noise [L, B, latent]
    (JAX's scan hands every microbatch the same patched noise, which the
    port gets tiled along its batch axis). Returns a dict:

      diffs: (loss terms and raw_kl, max relative; gradient, relative L2;
              share of parameter elements Adam's first update moves apart
              by more than lr/100; running statistics, max_rel), the
              pre-BatchNorm biases left out of the last three;
      pre_bn: (port, JAX) largest pre-BatchNorm bias gradient element over
              the largest gradient element;
      f64_gap: the port's gradient's relative L2 distance from a float64
              copy's, the same step;
      jax_f64_gap: JAX's gradient's distance from that float64 copy's."""
    from vae_song_tpu.train import state as jax_state
    from vae_song_tpu.train.steps import make_accum_train_step as jax_accum_step
    from vae_song_tpu.train.steps import make_train_step as jax_train_step
    from vae_song_tpu_torch import weights
    from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases
    from vae_song_tpu_torch.train.state import make_optimizer
    from vae_song_tpu_torch.train.steps import make_accum_train_step

    jmodel, params, bs, port = flex_pair(kind, arch, mixed, alpha=alpha, extra=extra)
    assert port.grad_mode == jmodel.grad_mode == ("staged" if kind == "lrvae" else "composite")
    x = flex_inputs(arch, batch, seed=7)
    eps = np.random.default_rng(8).normal(
        size=(n_samples, batch // n_micro, port.latent_channel)).astype(np.float32)
    patch_eps(monkeypatch, eps)
    keys = [k for k, _ in port.named_parameters()]
    before_bn = pre_batchnorm_biases(keys)
    live = [k for k in keys if k not in before_bn]

    def jax_step(no_jit):
        tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=lr))
        state = jax_state.TrainState.create(params, bs, tx)
        step = (jax_accum_step(jmodel, tx, n_micro, L=n_samples) if n_micro > 1
                else jax_train_step(jmodel, tx, L=n_samples))
        with jax.disable_jit(no_jit):
            state, m = step(state, jnp.asarray(x), wu_alpha, jax.random.PRNGKey(0))
        return ({k: float(v) for k, v in m.items()},
                weights.params_to_state_dict(to_np(state.opt_state[0]), keys),
                weights.params_to_state_dict(to_np(state.params), keys),
                to_np(state.batch_stats))

    jm, j_grads, j_after, j_stats = jax_step(eager)

    port_eps = np.concatenate([eps] * n_micro, axis=1)
    ref = copy.deepcopy(port).double()
    for m in ref.modules():                 # the f32 heads and the bf16 trunk too
        if getattr(m, "dtype", None) in (torch.float32, torch.bfloat16):
            m.dtype = torch.float64
    make_accum_train_step(ref, make_optimizer(ref.parameters(), lr=lr), n_micro)(
        torch.from_numpy(x).double(), torch.from_numpy(port_eps).double(), wu_alpha)
    pm = make_accum_train_step(port, make_optimizer(port.parameters(), lr=lr), n_micro)(
        torch.from_numpy(x), torch.from_numpy(port_eps), wu_alpha)
    grads = {k: p.grad for k, p in port.named_parameters()}
    assert all(g is not None for g in grads.values())
    f64 = {k: p.grad for k, p in ref.named_parameters()}
    f64_gap = grad_gap({k: g.double() for k, g in grads.items()}, f64, live)
    jax_f64_gap = grad_gap({k: g.double() for k, g in j_grads.items()}, f64, live)

    scale = max(float(g.abs().max()) for g in grads.values())
    pre_bn = tuple(max(float(g[k].abs().max()) for k in before_bn) / scale
                   for g in (grads, j_grads))
    rel = max(abs(float(pm[k]) - jm[k]) / max(abs(jm[k]), 1e-6)
              for k in ("loss", "recon", "reg", "lr", "raw_kl"))
    after = dict(port.named_parameters())
    share = float(torch.cat([(after[k].detach() - j_after[k]).abs().reshape(-1)
                             for k in live]).gt(lr / 100).float().mean())
    stats = max_rel(weights.state_dict_to_variables(port.state_dict())["batch_stats"], j_stats)
    return {"diffs": (rel, grad_gap(grads, j_grads, live), share, stats), "pre_bn": pre_bn,
            "f64_gap": f64_gap, "jax_f64_gap": jax_f64_gap}


# ---------------------------------------------------------------- the sharded steps


def jax_sharded_step(phase, port):
    """One train step of the JAX package's strategy phase["strategy"]
    ("fsdp": make_fsdp_train_step on a ('data',) mesh; "tp_dp":
    make_tp_dp_train_step; "tp_fsdp": make_tp_fsdp_train_step; both on
    phase["mesh"] = [n_data, n_model]; "sp", "sp_ring", "pp", "ep": see
    `_jax_model_parallel_step`) on conftest's virtual devices, from
    `port`'s weights and statistics, on the global batch phase["x"] with
    the noise phase["eps"] (patch_eps: every shard draws its block of
    it). Returns {"metrics", "grads" and "params" (state_dict-keyed
    tensors), "stats" (the batch_stats tree)}."""
    from vae_song_tpu.models import build_model as jax_build_model
    from vae_song_tpu.parallel import fsdp as jax_fsdp
    from vae_song_tpu.parallel import make_mesh
    from vae_song_tpu.parallel import tp as jax_tp
    from vae_song_tpu.train import state as jax_state
    from vae_song_tpu_torch import weights

    variables = weights.state_dict_to_variables(port.state_dict())
    jmodel = jax_build_model(phase["exp_type"], phase["dataset"], phase["model_params"],
                             beta=phase.get("beta", 1.0), alpha=phase.get("alpha", 0.01))
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=phase["lr"]))
    state = jax_state.TrainState.create(
        jax.tree.map(jnp.array, variables["params"]),
        jax.tree.map(jnp.array, variables.get("batch_stats", {})), tx)
    kind = phase["strategy"]
    if kind in ("sp", "sp_ring", "pp", "ep"):
        return _jax_model_parallel_step(phase, port, jmodel, variables)
    n_data, n_model = phase["mesh"]
    devices = jax.devices()[:n_data * n_model]
    mse = phase.get("min_shard_elems", jax_fsdp.DEFAULT_MIN_SHARD_ELEMS)
    mp = pytest.MonkeyPatch()
    patch_eps(mp, phase["eps"])
    try:
        if kind == "fsdp":
            mesh = jax_fsdp.make_fsdp_mesh(n_data, devices)
            state = jax_fsdp.shard_state(state, mesh, mse)
            step = jax_fsdp.make_fsdp_train_step(jmodel, tx, mesh, state, min_shard_elems=mse)
        elif kind == "tp_fsdp":
            mesh = make_mesh(n_data, n_model, devices)
            state = jax_fsdp.shard_state_tp_fsdp(state, mesh, mse)
            step = jax_fsdp.make_tp_fsdp_train_step(jmodel, tx, mesh, state,
                                                    min_shard_elems=mse)
        else:
            mesh = make_mesh(n_data, n_model, devices)
            state = jax_tp.shard_state(state, mesh)
            step = jax_tp.make_tp_dp_train_step(jmodel, tx, mesh, state)
        state, m = step(state, jnp.asarray(phase["x"]), jnp.float32(phase["wu"]),
                        jax.random.PRNGKey(0))
    finally:
        mp.undo()
    keys = [k for k, _ in port.named_parameters()]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": weights.params_to_state_dict(to_np(state.opt_state[0]), keys),
            "params": weights.params_to_state_dict(to_np(state.params), keys),
            "stats": to_np(state.batch_stats)}


def _jax_model_parallel_step(phase, port, jmodel, variables):
    """The JAX step of sequence parallelism ("sp": make_sp_train_step on a
    phase["mesh"] = [n_data, n_seq] mesh; "sp_ring": with ring=True),
    pipeline parallelism ("pp": make_setvae_pp_train_step on [n_data,
    n_stages], n_data 1 a ('stage',) mesh, phase["n_micro"]
    microbatches, phase["grad_clip"] in the step) or expert parallelism
    ("ep": make_setvae_ep_train_step on [n_experts]), its tx the port's
    Adam after grads_capture. Every shard's eps draw is patched to
    phase["eps"]'s first row block of the shard's size (patch_eps), as
    every port rank of the strategy takes the same block."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    from vae_song_tpu.parallel import ep as jax_ep
    from vae_song_tpu.parallel import pp as jax_pp
    from vae_song_tpu.parallel import pp_setvae as jax_pp_setvae
    from vae_song_tpu.parallel import sp as jax_sp
    from vae_song_tpu.train import state as jax_state
    from vae_song_tpu_torch import weights

    kind, shape = phase["strategy"], phase["mesh"]
    devices = jax.devices()[:int(np.prod(shape))]
    tx = optax.chain(grads_capture(), jax_state.make_optimizer(lr=phase["lr"]))
    params = jax.tree.map(jnp.array, variables["params"])
    eps_block = phase["eps"][:phase["eps"].shape[0] // shape[0]]
    x, wu, key = jnp.asarray(phase["x"]), jnp.float32(phase["wu"]), jax.random.PRNGKey(0)
    mp = pytest.MonkeyPatch()
    patch_eps(mp, eps_block)
    try:
        if kind in ("sp", "sp_ring"):
            mesh = jax_sp.make_sp_mesh(*shape, devices)
            state = jax.device_put(jax_state.TrainState.create(params, {}, tx),
                                   NamedSharding(mesh, P()))
            step = jax_sp.make_sp_train_step(jmodel, tx, mesh, ring=kind == "sp_ring")
            state, m = step(state, jax_sp.shard_points(x, mesh), wu, key)
            grads, params = state.opt_state[0], state.params
        elif kind == "ep":
            mesh = jax_ep.make_ep_mesh(shape[0], devices)
            base = jax_state.TrainState.create(params, {}, tx)
            step = jax_ep.make_setvae_ep_train_step(jmodel, tx, mesh, base,
                                                    grad_clip=phase.get("grad_clip"))
            state = jax_ep.shard_setvae_ep_state(base, mesh)
            state, m = step(state, jax.device_put(x, NamedSharding(mesh, P("expert"))), wu, key)
            grads, params = state.opt_state[0], state.params
        else:
            n_data, n_stages = shape
            n_layers = jmodel.num_encoder_layers
            mesh = (jax_pp_setvae.make_dp_pp_mesh(n_data, n_stages, devices) if n_data > 1
                    else jax_pp.make_pp_mesh(n_stages, devices))
            pp0 = jax_pp_setvae.split_params(params, n_layers)
            p_pp, o_pp = jax_pp_setvae.shard_pp_setvae_state(pp0, tx.init(pp0), mesh, tx)
            step = jax_pp_setvae.make_setvae_pp_train_step(jmodel, tx, mesh, phase["n_micro"],
                                                           grad_clip=phase.get("grad_clip"))
            if n_data > 1:
                x = jax.device_put(x, NamedSharding(mesh, P("data")))
            p_pp, o_pp, m = step(p_pp, o_pp, x, wu, key)
            grads = jax_pp_setvae.merge_params(o_pp[0], n_layers)
            params = jax_pp_setvae.merge_params(p_pp, n_layers)
    finally:
        mp.undo()
    keys = [k for k, _ in port.named_parameters()]
    return {"metrics": {k: float(v) for k, v in m.items()},
            "grads": weights.params_to_state_dict(to_np(grads), keys),
            "params": weights.params_to_state_dict(to_np(params), keys), "stats": {}}


def port_spec_as_flax(name, spec, ndim):
    """A port placement (a tuple over the parameter's port axes, () for
    whole) laid out over its Flax axes (a Dense weight [out, in] is the
    kernel [in, out]), padded with None to `ndim`."""
    from vae_song_tpu_torch.parallel.fsdp import _flax_axes

    out = [None] * ndim
    for i, a in enumerate(tuple(spec) + (None,) * (ndim - len(spec))):
        out[_flax_axes(name, ndim)[i]] = a
    return tuple(out)


def jax_spec_at(specs, name, ndim):
    """The JAX PartitionSpec, in the tree `specs` over a Flax params tree,
    of port parameter `name`, as a tuple padded with None to `ndim`."""
    from vae_song_tpu_torch import weights

    node = specs
    for key in weights.flax_path(name)[1]:
        node = node[key]
    return tuple(node) + (None,) * (ndim - len(tuple(node)))


def sharded_jax_gaps(got, want, lr):
    """(loss terms and raw_kl, max relative; gradient, relative L2; share
    of parameter elements the update leaves apart by more than lr/100;
    running statistics, max_rel, 0 without BatchNorm) of a port rank's
    step output `got` (numpy trees: "metrics", "grads", "state") against
    `jax_sharded_step`'s. Left out of the last three: the biases before a
    BatchNorm and the attention's key biases, whose gradient is zero
    analytically (roundoff on both sides)."""
    from vae_song_tpu_torch import weights
    from vae_song_tpu_torch.nn.blocks import pre_batchnorm_biases

    keys = list(want["params"])
    live = [k for k in keys if k not in pre_batchnorm_biases(keys)
            and not k.endswith("key.bias") and k in got["grads"]]
    rel = max(abs(got["metrics"][k] - want["metrics"][k]) / max(abs(want["metrics"][k]), 1e-6)
              for k in want["metrics"])
    gap = grad_gap({k: torch.from_numpy(got["grads"][k]) for k in live}, want["grads"], live)
    share = float(np.mean(np.concatenate([
        (np.abs(got["state"][k] - want["params"][k].numpy()) > lr / 100).reshape(-1)
        for k in live])))
    stats = 0.0
    if jax.tree.leaves(want["stats"]):
        stats = max_rel(weights.state_dict_to_variables(
            {k: torch.from_numpy(v) for k, v in got["state"].items()})["batch_stats"],
            want["stats"])
    return rel, gap, share, stats


# ---------------------------------------------------------------- the Lipschitz CLI

# a small Lipschitz CLI run (2 epochs of 600 points, 4 x 4 and 3 x 3 grids)
# and each model's flags
LIPSCHITZ_SMALL = ["--epochs", "2", "--train_total_samples", "600", "--K", "4", "--K_z", "3",
                   "--batch_size", "64", "--num_training_components", "2", "--seed", "5",
                   "--beta", "0.1"]
LIPSCHITZ_ARGS = {"lrvae": ["--model", "lrvae", "--alpha", "0.1", "--hidden_channels", "8", "8",
                            "2"],
                  "lidvae": ["--model", "lidvae", "--IL", "0.2", "--hidden_channels", "8", "2"]}


def csv_rows(path):
    import csv

    with open(path, newline="") as f:
        return list(csv.reader(f))


def lipschitz_jax_run(argv, out):
    """JAX's `cli.lipschitz.main(argv)` into `out` with its plots switched
    off: {state: the trained TrainState, metrics: its returned dict,
    fields: experiment_metrics.csv's rows, exp_lip: ../exp_lip.csv's}."""
    import pytest

    from vae_song_tpu import viz as jax_viz
    from vae_song_tpu.cli import lipschitz as jax_lip

    captured, train_model = {}, jax_lip.train_model

    def capture(*a, **k):
        captured["out"] = train_model(*a, **k)
        return captured["out"]

    mp = pytest.MonkeyPatch()
    try:
        for name in ("plot_heatmap", "plot_2d_histogram"):
            mp.setattr(jax_viz, name, lambda *a, **k: None)
        mp.setattr(jax_lip, "train_model", capture)
        metrics = jax_lip.main(argv + ["--output_dir", str(out)])
    finally:
        mp.undo()
    return dict(state=captured["out"][0], metrics=metrics,
                fields=csv_rows(out / "experiment_metrics.csv"),
                exp_lip=csv_rows(out.parent / "exp_lip.csv"))


def lipschitz_jax_draws(seed, n, K, K_z, zdim=2):
    """The draws JAX's Lipschitz CLI makes after training, from its key
    splits, as the port's AnalysisDraws."""
    from vae_song_tpu_torch.cli import lipschitz as L

    t = lambda a: torch.from_numpy(np.array(a))
    pairs = lambda key, shape, high: tuple(
        t(jax.random.randint(k, shape, 0, high)) for k in jax.random.split(key))
    key = jax.random.PRNGKey(seed)
    key, kz = jax.random.split(key)
    z_test_eps = t(jax.random.normal(kz, (n, zdim)))
    key, kg, kl_key = jax.random.split(key, 3)
    cell_seed = int(jax.random.randint(kg, (), 0, 2 ** 31 - 1))
    x_pairs = pairs(kl_key, (K * K, L.CELL_PAIRS), L.CELL_SAMPLES)
    key, kzs, kzl = jax.random.split(key, 3)
    z_grid_eps = t(jax.random.normal(kzs, (K_z * K_z, L.Z_GRID_SAMPLES, 2)))
    z_pairs = pairs(kzl, (K_z * K_z, L.CELL_PAIRS), L.Z_GRID_SAMPLES)
    key, kd, kl2 = jax.random.split(key, 3)
    if n < L.DATA_SAMPLES:
        perm, eps = None, t(jax.random.normal(kd, (n, L.DATA_SAMPLES // n + 1, zdim)))
    else:
        k1, k2 = jax.random.split(kd)
        perm = t(jax.random.permutation(k1, n))
        eps = t(jax.random.normal(k2, (L.DATA_SAMPLES, zdim)))
    return L.AnalysisDraws(z_test_eps, cell_seed, x_pairs, z_grid_eps, z_pairs, eps, perm,
                           pairs(kl2, (L.DATA_PAIRS,), L.DATA_SAMPLES))


def check_lipschitz_analysis(run, argv):
    """JAX-trained parameters (`run`, lipschitz_jax_run's), JAX's data and
    JAX's draws: the port's analysis stage gives the X and Z fields of
    JAX's experiment_metrics.csv (per-cell KL and Lipschitz) and its
    data-based KL and L(z). f32 on both sides; bound 1e-4 relative to
    each field's largest magnitude (measured up to 3.2e-5 LRVAE, 2.4e-5
    LIDVAE, both in the Z-grid Lipschitz quantiles; the data-based metrics
    6.2e-7). An untrained LIDVAE's decode reaches 1e10 and its Z-grid KL
    overflows to NaN in both packages: NaN must then meet NaN."""
    import pytest

    from vae_song_tpu_torch import weights
    from vae_song_tpu_torch.cli import lipschitz as L
    from vae_song_tpu_torch.models.flexible import LRVAE
    from vae_song_tpu_torch.models.lidvae import LIDVAE

    args = L.build_argparser().parse_args(argv)
    hchans = tuple(args.hidden_channels)
    if args.model == "lidvae":
        port = LIDVAE.for_dataset("pinwheel", hidden_channels=hchans, inverse_lipschitz=args.IL,
                                  beta=args.beta)
    else:
        port = LRVAE.for_dataset("pinwheel", hidden_channels=hchans, encoder_type="mlp",
                                 decoder_type="mlp", alpha=args.alpha, beta=args.beta)
    weights.load_flax_params(port, to_np(run["state"].params), to_np(run["state"].batch_stats))
    X = L.generate_simple_gaussian_mixture(
        num_components=args.num_training_components, total_samples=args.train_total_samples,
        center_range=args.K, stds=args.std, pattern=args.distribution_pattern, seed=args.seed)[0]
    f = L.analyse(port, X, args.K, args.K_z, lipschitz_jax_draws(args.seed, len(X), args.K,
                                                                 args.K_z))
    rows = run["fields"][1:]
    assert len(rows) == args.K ** 2 + args.K_z ** 2
    want = {(r[1], int(r[2])): (float(r[3]), float(r[4])) for r in rows}
    for space, sfx, k in (("X", "x", args.K), ("Z", "z", args.K_z)):
        for col, name in ((0, f"kl_{sfx}"), (1, f"lips_{sfx}")):
            w = np.array([want[(space, i)][col] for i in range(k * k)])
            np.testing.assert_allclose(f[name], w, rtol=0,
                                       atol=1e-4 * max(1.0, float(np.abs(w).max())))
    got = {"kl": f["data_kl"], "bi_lips": f["data_bi"], "inv_lips": f["data_inv"],
           "lips": f["data_lips"]}
    assert got == pytest.approx(run["metrics"], rel=1e-4)
