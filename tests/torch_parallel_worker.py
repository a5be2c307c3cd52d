"""Rank process of the port's parallel tests (tests/test_torch_parallel_*.py)
-- NOT a pytest file, and it imports no JAX.

`run_ranks(job, world, tmp_path)` (or `start_ranks`, then
`wait_ranks`) writes a job (.npz), starts `world` processes of this file
on the CPU, each of which opens a gloo process
group, runs the job's phases in order (every rank in step, as the
collectives need) and writes what it found to out_<rank>.npz; the test
reads those back. One torch thread a rank. A phase is a dict with "fn"
(the name of a function below) and its arguments; each returns a tree of
numpy arrays and numbers.
"""

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 240


# ---------------------------------------------------------------- trees in .npz


def dump(path, tree):
    """Write a tree of dicts, lists, numbers, strings and numpy arrays to an
    .npz: the arrays under their own keys, the rest as JSON."""
    arrays = {}

    def enc(node):
        if isinstance(node, dict):
            return {k: enc(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [enc(v) for v in node]
        if isinstance(node, np.ndarray):
            key = f"a{len(arrays)}"
            arrays[key] = node
            return {"__array__": key}
        if isinstance(node, np.generic):
            return node.item()
        return node

    meta = json.dumps(enc(tree))
    np.savez(path, __json__=np.array(meta), **arrays)


def load(path):
    with np.load(path) as f:
        arrays = {k: f[k] for k in f.files}

    def dec(node):
        if isinstance(node, dict):
            if set(node) == {"__array__"}:
                return arrays[node["__array__"]]
            return {k: dec(v) for k, v in node.items()}
        if isinstance(node, list):
            return [dec(v) for v in node]
        return node

    return dec(json.loads(str(arrays.pop("__json__"))))


def start_ranks(job: dict, world: int, tmp_path):
    """Start `job` on `world` gloo ranks; returns the handle `wait_ranks`
    takes, so the caller can work while the ranks run."""
    tmp = str(tmp_path)
    path = os.path.join(tmp, "job.npz")
    dump(path, job)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1", MASTER_ADDR="localhost",
               MASTER_PORT=str(port), WORLD_SIZE=str(world))
    logs = [open(os.path.join(tmp, f"rank{r}.log"), "w+") for r in range(world)]
    procs = [subprocess.Popen([sys.executable, __file__, path, tmp],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
                              stdout=logs[r], stderr=subprocess.STDOUT, cwd=tmp)
             for r in range(world)]
    return tmp, procs, logs, time.time() + TIMEOUT_S


def wait_ranks(handle) -> list:
    """Each rank's output tree of a `start_ranks` run. Raises with the
    ranks' output when one fails or the run outlasts TIMEOUT_S."""
    tmp, procs, logs, deadline = handle
    try:
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    text = []
    for r, f in enumerate(logs):
        f.seek(0)
        text.append(f"--- rank {r} (exit {procs[r].returncode})\n{f.read()[-4000:]}")
        f.close()
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("parallel ranks failed:\n" + "\n".join(text))
    return [load(os.path.join(tmp, f"out_{r}.npz")) for r in range(len(procs))]


def run_ranks(job: dict, world: int, tmp_path) -> list:
    """`start_ranks`, then `wait_ranks`."""
    return wait_ranks(start_ranks(job, world, tmp_path))


# ---------------------------------------------------------------- the phases


def _np(t):
    from vae_song_tpu_torch.nn.sync import full_tensor

    return full_tensor(t).detach().float().cpu().numpy()


def _local_heads(model) -> list[int]:
    """The head count each attention module runs on this rank: its query
    projection's rows on this rank over the head width (FSDP's split of
    the stored weight is gathered for the forward, so it does not
    count)."""
    from vae_song_tpu_torch.ops.attention import MultiHeadAttention

    out = []
    for m in model.modules():
        if isinstance(m, MultiHeadAttention):
            w, split = m.query.weight, 1
            names = getattr(getattr(w, "device_mesh", None), "mesh_dim_names", None) or ()
            if "model" in names and getattr(w.placements[names.index("model")], "dim", None) == 0:
                split = w.device_mesh.size(names.index("model"))
            out.append(w.shape[0] // split // (m.d_model // m.num_heads))
    return out


def _model(spec):
    import torch

    from vae_song_tpu_torch import weights
    from vae_song_tpu_torch.models.registry import build_model

    m = build_model(spec["exp_type"], spec["dataset"], spec["model_params"],
                    beta=spec.get("beta", 1.0), alpha=spec.get("alpha", 0.01),
                    generator=torch.Generator().manual_seed(spec.get("seed", 0)))
    if "flax_params" in spec:
        weights.load_flax_params(m, spec["flax_params"], spec.get("flax_batch_stats"))
    return m


def _state_np(model) -> dict:
    return {k: _np(v) for k, v in model.state_dict().items()}


def _metrics_np(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def dp(spec):
    """The data-parallel eval step, then one train step (x the global
    batch, eps this rank's block), and the pmean-of-shard-gradients
    property: DDP's reduced gradient against the mean of the ranks'
    make_grads_fn gradients."""
    import copy

    import torch
    import torch.distributed as dist

    from vae_song_tpu_torch.parallel import mesh as mesh_lib
    from vae_song_tpu_torch.train.state import TrainState, make_optimizer
    from vae_song_tpu_torch.train.steps import make_grads_fn

    model = _model(spec)
    opt = make_optimizer(model.parameters(), lr=spec["lr"])
    state = TrainState(model, opt)
    mesh = mesh_lib.make_mesh()
    mesh_lib.replicate_state(state, mesh)
    x = mesh_lib.shard_batch(torch.from_numpy(spec["x"]), mesh)
    eps = torch.from_numpy(spec["eps"])
    ev = mesh_lib.make_dp_eval_step(model, mesh)(x, eps, spec["wu"])
    ref = copy.deepcopy(model)
    grads, _ = make_grads_fn(ref, list(ref.parameters()))(x, eps, spec["wu"])
    m = mesh_lib.make_dp_train_step(model, opt, mesh)(x, eps, spec["wu"])
    gap = 0.0
    for g, p in zip(grads, model.parameters()):
        if g is None:
            assert p.grad is None
            continue
        all_g = [torch.empty_like(g) for _ in range(dist.get_world_size())]
        dist.all_gather(all_g, g)
        mean = torch.stack(all_g).mean(0)
        gap = max(gap, float((mean - p.grad).abs().max()))
    return {"metrics": _metrics_np(m), "eval": _metrics_np(ev), "state": _state_np(model),
            "grads": {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None},
            "pmean_gap": gap, "count": opt.count}


def _strategy_state(spec):
    """(state, train step, eval step, mesh) of spec["strategy"]: fsdp,
    tp_dp or tp_fsdp on spec["mesh"]."""
    import torch.distributed as dist

    from vae_song_tpu_torch.parallel import fsdp, optree, tp
    from vae_song_tpu_torch.parallel import mesh as mesh_lib
    from vae_song_tpu_torch.train.state import TrainState, make_optimizer

    # seed_by_rank: each rank draws its own weights, which the strategy
    # must replace by the first rank's
    rank_seed = dist.get_rank() if spec.get("seed_by_rank") else 0
    model = _model(dict(spec, seed=spec.get("seed", 0) + rank_seed))
    opt = make_optimizer(model.parameters(), lr=spec["lr"], grad_clip=spec.get("grad_clip"))
    state = TrainState(model, opt)
    mesh = mesh_lib.make_mesh(*spec["mesh"])
    kind, mse = spec["strategy"], spec.get("min_shard_elems", fsdp.DEFAULT_MIN_SHARD_ELEMS)
    if kind == "fsdp":
        state = fsdp.shard_state(state, mesh, mse)
        step = fsdp.make_fsdp_train_step(model, opt, mesh, state.fsdp_params)
    elif kind == "tp_fsdp":
        state = fsdp.shard_state_tp_fsdp(state, mesh, mse)
        step = fsdp.make_tp_fsdp_train_step(model, opt, mesh, state.fsdp_params)
    else:
        state = tp.shard_state(state, mesh)
        step = tp.make_tp_dp_train_step(model, opt, mesh)
    return state, step, optree.make_gspmd_eval_step(model, mesh), mesh


def _routed():
    from vae_song_tpu_torch.models import setvae
    from vae_song_tpu_torch.ops import attention

    return ((attention, "dense_attention"), (attention, "dense_attention_fwd"),
            (attention, "attention_plain"), (setvae, "fused_ffn"))


def _count_routes() -> dict:
    """Count the calls of the attention routes and the fused FFN (until
    `_uncount_routes`); returns the live counts."""
    routes = {}
    for module, name in _routed():
        fn, routes[name] = getattr(module, name), 0

        def counted(*a, _fn=fn, _name=name, **kw):
            routes[_name] += 1
            return _fn(*a, **kw)

        setattr(module, name, counted)
    return routes


def _uncount_routes() -> None:
    for module, name in _routed():
        setattr(module, name, getattr(module, name).__kwdefaults__["_fn"])


def sharded(spec):
    """One train step of a weight-sharding strategy on the global batch x
    and its noise eps (each rank takes its slice), then the eval step:
    metrics, the gradients and the updated state gathered whole, each
    parameter's and first moment's local shape, the attention modules'
    local head counts and the attention routes taken."""
    import torch

    from vae_song_tpu_torch.parallel.mesh import shard_batch

    for k, v in spec.get("env", {}).items():
        os.environ[k] = v
    routes = _count_routes()
    state, step, eval_step, mesh = _strategy_state(spec)
    model = state.model
    x, eps = torch.from_numpy(spec["x"]), torch.from_numpy(spec["eps"])
    xs, es = shard_batch(x, mesh), shard_batch(eps, mesh, eps.dim() - 2)
    m = step(xs, es, spec["wu"])
    grads = {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    ev = eval_step(xs, es, spec["wu"])
    local = {n: list(p.to_local().shape if type(p).__name__ == "DTensor" else p.shape)
             for n, p in model.named_parameters()}
    mu_local = {n: list(getattr(mu, "to_local", lambda: mu)().shape)
                for (n, _), mu in zip(model.named_parameters(), state.optimizer.adam.mu)}
    for k in spec.get("env", {}):
        del os.environ[k]
    _uncount_routes()
    return {"metrics": _metrics_np(m), "eval": _metrics_np(ev), "grads": grads,
            "state": _state_np(model), "local": local, "mu_local": mu_local,
            "heads": _local_heads(model), "routes": routes}


def replicated(spec):
    """The state a strategy starts from, gathered whole, where each rank
    drew its own weights (spec["seed_by_rank"])."""
    state, *_ = _strategy_state(spec)
    return {"state": _state_np(state.model)}


def clip(spec):
    """The sharded clip (optree.make_shardmap_clip) of each of
    spec["clips"] over the gradients of one strategy step taken without
    a clip, gathered whole."""
    import torch

    from vae_song_tpu_torch.parallel.mesh import shard_batch
    from vae_song_tpu_torch.parallel.optree import make_shardmap_clip

    state, step, _, mesh = _strategy_state(spec)
    x, eps = torch.from_numpy(spec["x"]), torch.from_numpy(spec["eps"])
    step(shard_batch(x, mesh), shard_batch(eps, mesh, eps.dim() - 2), spec["wu"])
    names = [n for n, p in state.model.named_parameters() if p.grad is not None]
    params = [p for p in state.model.parameters() if p.grad is not None]
    out = {}
    for i, cfg in enumerate(spec["clips"]):
        grads = [p.grad.clone() for p in params]
        make_shardmap_clip(cfg)(grads)
        out[str(i)] = {n: _np(g) for n, g in zip(names, grads)}
    return {"clipped": out}


def _sub_mesh(shape, names):
    """A DeviceMesh over the first prod(shape) ranks of the group (every
    rank builds it; the others are outside it: coordinate None)."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    n = int(np.prod(shape))
    return DeviceMesh("cpu", torch.arange(n).view(*shape), mesh_dim_names=names)


def strategy(spec):
    """One train step of sequence ("sp", "sp_ring"), pipeline ("pp") or
    expert ("ep") parallelism on the first ranks of the group (spec
    ["mesh"]: [n_data, n_inner]; [n_experts] for ep), x the global batch
    and eps the global noise, each rank taking its block; then the eval
    step where the strategy has one. Returns the metrics, this rank's
    gradients (gathered whole; under PP only its stage's layers and the
    replicated entries), the state after the update (under PP after
    pp_sync, moments included) and the eval metrics; {} on ranks outside
    the mesh."""
    import torch

    from vae_song_tpu_torch.parallel import ep, pp_setvae, sp
    from vae_song_tpu_torch.parallel.mesh import shard_batch
    from vae_song_tpu_torch.train.state import TrainState, make_optimizer

    kind = spec["strategy"]
    names = {"sp": ("data", "seq"), "sp_ring": ("data", "seq"), "pp": ("data", "stage"),
             "ep": ("expert",)}[kind]
    mesh = _sub_mesh(spec["mesh"], names)
    if mesh.get_coordinate() is None:
        return {}
    rank_seed = mesh.get_rank() if spec.get("seed_by_rank") else 0
    model = _model(dict(spec, seed=spec.get("seed", 0) + rank_seed))
    opt = make_optimizer(model.parameters(), lr=spec["lr"], grad_clip=spec.get("grad_clip"))
    state = TrainState(model, opt)
    x, eps = torch.from_numpy(spec["x"]), torch.from_numpy(spec["eps"])
    ev = None
    routes = _count_routes()
    if kind in ("sp", "sp_ring"):
        from vae_song_tpu_torch.parallel.mesh import replicate_state

        replicate_state(state, mesh)
        ring = kind == "sp_ring"
        xs, es = sp.shard_points(x, mesh), shard_batch(eps, mesh)
        m = sp.make_sp_train_step(model, opt, mesh, ring)(xs, es, spec["wu"])
        ev = sp.make_sp_eval_step(model, mesh, ring)(xs, es, spec["wu"])
    elif kind == "pp":
        pp_setvae.shard_pp_setvae_state(state, mesh)
        step = pp_setvae.make_setvae_pp_train_step(model, opt, mesh, spec["n_micro"])
        m = step(shard_batch(x, mesh), shard_batch(eps, mesh), spec["wu"])
    else:
        ep.shard_setvae_ep_state(state, mesh)
        xs, es = (shard_batch(t, mesh, axis="expert") for t in (x, eps))
        m = ep.make_setvae_ep_train_step(model, opt, mesh)(xs, es, spec["wu"])
        ev = ep.make_setvae_ep_eval_step(model, mesh)(xs, es, spec["wu"])
    _uncount_routes()
    grads = {n: _np(p.grad) for n, p in model.named_parameters() if p.grad is not None}
    if kind == "pp":
        pp_setvae.pp_sync(state, mesh, with_opt=True)
    out = {"metrics": _metrics_np(m), "grads": grads, "state": _state_np(model),
           "routes": routes,
           "mu": {n: _np(mu) for (n, _), mu in zip(model.named_parameters(), opt.adam.mu)},
           "count": opt.count}
    if ev is not None:
        out["eval"] = _metrics_np(ev)
    return out


def sp_ops(spec):
    """On the first spec["n"] ranks, each holding its point shard of q, k,
    v [B, N, H, D] and of the output cotangent, and of the clouds pred,
    gt [B, N, 3]: sequence_sharded_attention's and ring_attention's
    output and q/k/v gradients, chamfer_sp's per-shard value and cloud
    gradients, this rank's shards."""
    import torch

    from vae_song_tpu_torch.ops.attention import ring_attention, sequence_sharded_attention
    from vae_song_tpu_torch.ops.chamfer import chamfer_sp

    mesh = _sub_mesh((spec["n"],), ("seq",))
    if mesh.get_coordinate() is None:
        return {}
    group, i, n = mesh.get_group("seq"), mesh.get_local_rank("seq"), spec["n"]

    def local(name):
        t = torch.from_numpy(spec[name])
        size = t.shape[1] // n
        return t.narrow(1, i * size, size).clone().requires_grad_()

    out = {}
    for name, fn in (("all_gather", sequence_sharded_attention), ("ring", ring_attention)):
        q, k, v = local("q"), local("k"), local("v")
        o = fn(q, k, v, spec["scale"], group)
        o.backward(local("do").detach())
        out[name] = {"out": o.detach().numpy(), "dq": q.grad.numpy(), "dk": k.grad.numpy(),
                     "dv": v.grad.numpy()}
    pred, gt = local("pred"), local("gt")
    c = chamfer_sp(pred, gt, group)
    c.backward()
    out["chamfer"] = {"value": float(c), "dpred": pred.grad.numpy(), "dgt": gt.grad.numpy()}
    return out


def residual_block(p, x):
    """The generic pipeline tests' block: x + tanh(x @ w + b)."""
    import torch

    return x + torch.tanh(x @ p["w"] + p["b"])


def pp_generic(spec):
    """parallel/pp.py's generic GPipe on the first spec["n"] ranks: this
    stage's slice of spec["w"], spec["b"] (stacked [L, ...]), one
    make_pp_train_step step of the MSE loss at lr 0 (so the gradients
    are read back unchanged), then the pipelined forward. Returns the
    loss, the forward's output and this stage's gradients."""
    import torch

    from vae_song_tpu_torch.parallel import pp
    from vae_song_tpu_torch.train.state import make_optimizer

    mesh = _sub_mesh((spec["n"],), ("stage",))
    if mesh.get_coordinate() is None:
        return {}
    stacked = {k: torch.from_numpy(spec[k]) for k in ("w", "b")}
    local = pp.shard_pp_state(stacked, mesh)
    opt = make_optimizer(list(local.values()), lr=0.0)
    n_layers = spec["w"].shape[0]
    step = pp.make_pp_train_step(residual_block, lambda y, t: ((y - t) ** 2).mean(), opt,
                                 mesh, n_layers, spec["n_micro"])
    x, t = torch.from_numpy(spec["x"]), torch.from_numpy(spec["t"])
    loss = step(local, x, t)
    with torch.no_grad():
        y = pp.make_pp_apply(residual_block, mesh, n_layers, spec["n_micro"])(local, x)
    return {"loss": float(loss), "y": y.numpy(),
            "grads": {k: v.grad.numpy() for k, v in local.items()}}


def ep_generic(spec):
    """parallel/ep.py's standalone MoE on the first spec["n"] ranks:
    init_moe(generator seeded spec["seed"]) split by shard_moe, this
    rank's tokens of spec["x"] through make_ep_apply, then one
    make_ep_train_step step (lr 0) of the MSE against spec["t"]. Returns
    this rank's output, the loss and the gradients gathered whole."""
    import torch

    from vae_song_tpu_torch.parallel import ep
    from vae_song_tpu_torch.parallel.mesh import shard_batch
    from vae_song_tpu_torch.train.state import make_optimizer

    mesh = _sub_mesh((spec["n"],), ("expert",))
    if mesh.get_coordinate() is None:
        return {}
    d, h = spec["x"].shape[1], spec["hidden"]
    params = ep.init_moe(d, h, spec["n"], torch.Generator().manual_seed(spec["seed"]))
    params = ep.MoEParams(*(torch.nn.Parameter(t) for t in ep.shard_moe(params, mesh)))
    x, t = (shard_batch(torch.from_numpy(spec[k]), mesh, axis="expert") for k in ("x", "t"))
    with torch.no_grad():
        y = ep.make_ep_apply(mesh, spec["cf"])(params, x)
    opt = make_optimizer(list(params), lr=0.0)
    ep.shard_moe_opt(opt, params, mesh)
    loss = ep.make_ep_train_step(opt, mesh, params, spec["cf"])(x, t)
    return {"y": y.numpy(), "loss": float(loss),
            "grads": {f: _np(p.grad) for f, p in zip(ep.MoEParams._fields, params)}}


def dryrun(spec):
    """parallel/dryrun.py's dry run on the whole group: {phase: delta}."""
    import torch.distributed as dist

    from vae_song_tpu_torch.parallel.dryrun import dryrun_multichip

    return {"deltas": dryrun_multichip(dist.get_world_size())}


def trainer(spec):
    """`train_and_test` with spec["kwargs"] on the model of spec; the eval
    means, the step count and the trained state gathered whole."""
    import glob

    from vae_song_tpu_torch.train.loop import train_and_test

    kwargs = dict(spec["kwargs"])
    if "*" in kwargs.get("resume_from", ""):
        # a checkpoint an earlier phase wrote, under its run's name
        (kwargs["resume_from"],) = glob.glob(kwargs["resume_from"])
    state, summary = train_and_test(_model(spec), device="cpu", **kwargs)
    return {"eval": {k: float(v) for k, v in summary["eval"].items()},
            "step": int(state.step), "state": _state_np(state.model),
            "result_dir": summary["result_dir"]}


def main():
    job_path, outdir = sys.argv[1], sys.argv[2]
    import torch

    torch.set_num_threads(1)
    import torch.distributed as dist

    from vae_song_tpu_torch.parallel.mesh import init_multihost

    rank, _ = init_multihost("gloo")
    job = load(job_path)
    out = {}
    for i, phase in enumerate(job["phases"]):
        t0 = time.perf_counter()
        out[phase.get("name", str(i))] = globals()[phase["fn"]](phase)
        dist.barrier()
        print(f"phase {phase.get('name', i)}: {time.perf_counter() - t0:.2f} s", flush=True)
    dump(os.path.join(outdir, f"out_{rank}.npz"), out)
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
