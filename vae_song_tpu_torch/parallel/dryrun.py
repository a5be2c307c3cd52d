"""The multi-rank dry run: every parallel strategy of the port for one
step at tiny shapes against its single-device (or per-shard dense)
reference, with the parity delta printed and asserted (port of the JAX
package's `dryrun_multichip`, __graft_entry__.py:94-441).

    python -m vae_song_tpu_torch.parallel.dryrun [--ranks N]

starts N ranks, one a card, under NCCL (default: every visible card; it
refuses where fewer than N cards are visible);

    python -m vae_song_tpu_torch.parallel.dryrun --device cpu [--ranks N]

starts N gloo ranks on the CPU (default 4). Under `torchrun
--nproc_per_node N -m vae_song_tpu_torch.parallel.dryrun [--device cpu]`
it runs on the launch's ranks. Inside an open process group
`dryrun_multichip(n)` runs on it.

The phases, each on every rank of the group:

  * DP: a conv LRVAE (staged gradient, BatchNorm, a norm clip), the
    mean of the shards' single-device gradients, then the update;
  * DP x TP (an even rank count): SetLRVAE with heads and FFN columns on
    'model', against the single-device step on the global batch;
  * DP x SP (4 ranks or more, even): SetLRVAE's points on 'seq', against
    the mean of the rows' single-device losses;
  * PP: SetVAE with one encoder layer a stage, z = mu, against the
    single-device step; DP x PP (4 ranks or more): two pipelines;
  * EP: SetVAE with one MoE expert a rank, against the mean of the
    shards' dense-MoE losses;
  * FSDP: the conv LRVAE with its parameters split, against the
    single-device step on the global batch.
"""

import argparse
import copy
import os
import subprocess
import sys

import numpy as np
import torch
import torch.distributed as dist

SET = dict(latent_channel=8, num_points=32, d_model=16, num_heads=2, ff_dim=32)


def _build(exp_type, dataset, params, **kw):
    from vae_song_tpu_torch.models.registry import build_model

    return build_model(exp_type, dataset, params, beta=0.1, alpha=0.1,
                       generator=torch.Generator().manual_seed(0), **kw)


def _noise(shape, seed):
    return torch.randn(*shape, generator=torch.Generator().manual_seed(seed))


def _to(dev, *ts):
    return [t.to(dev) for t in ts]


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(1.0, abs(b))


def _mean_reference(model, batches, wu, dev):
    """The data-parallel reference on one rank: the mean over `batches`
    [(x, eps), ...] of the single-device gradients and losses, applied by
    the model's own optimizer. Returns (loss, the model after the update)."""
    from vae_song_tpu_torch.train.state import make_optimizer
    from vae_song_tpu_torch.train.steps import make_grads_fn

    ref = copy.deepcopy(model).to(dev)
    opt = make_optimizer(ref.parameters(), lr=1e-3,
                         grad_clip={"enabled": True, "clip_type": "norm", "max_norm": 1.0})
    params = list(ref.parameters())
    acc, losses = [None] * len(params), []
    for x, eps in batches:
        grads, m = make_grads_fn(ref, params)(x, eps, wu)
        losses.append(float(m[0]))
        acc = [a if g is None else g / len(batches) if a is None else a + g / len(batches)
               for a, g in zip(acc, grads)]
    for p, g in zip(params, acc):
        p.grad = g
    opt.step()
    return float(np.mean(losses)), ref


def _state(model, lr=1e-3, clip=True):
    from vae_song_tpu_torch.train.state import TrainState, make_optimizer

    grad_clip = {"enabled": True, "clip_type": "norm", "max_norm": 1.0} if clip else None
    return TrainState(model, make_optimizer(model.parameters(), lr=lr, grad_clip=grad_clip))


def _param_delta(a, b) -> float:
    """The largest difference of a parameter of `a` and `b` (the running
    BatchNorm statistics are left out: the reference moves them shard
    after shard, DP by the shards' mean)."""
    from vae_song_tpu_torch.nn.sync import full_tensor

    pb = dict(b.named_parameters())
    return max(float((full_tensor(v) - pb[k]).detach().abs().max())
               for k, v in a.named_parameters())


def _report(deltas, name, loss, ref, bound, extra=""):
    delta = _rel(loss, ref)
    assert np.isfinite(loss), f"non-finite loss in the multi-rank dry run ({name}): {loss}"
    assert delta < bound, f"{name} loss {loss} != reference {ref} (delta {delta:.2e})"
    deltas[name] = delta
    if dist.get_rank() == 0:
        print(f"dryrun_multichip {name} OK{extra}; loss={loss:.4f} "
              f"(reference parity delta={delta:.2e})", flush=True)


def _body(n: int, dev) -> dict:
    from vae_song_tpu_torch.parallel import ep, fsdp, mesh as mesh_lib, pp, pp_setvae, sp, tp

    deltas = {}
    rank = dist.get_rank()

    # DP: the conv LRVAE, per-shard semantics, its clip on the mean
    conv = _build("lrvae", "mnist", dict(hchans=[4, 4], encoder_type="conv",
                                         decoder_type="mlp"))
    per = 2
    x = torch.rand(per * n, 28, 28, 1, generator=torch.Generator().manual_seed(0))
    eps = _noise((1, per * n, conv.latent_channel), 1)
    x, eps = _to(dev, x, eps)
    shards = [(x[i * per:(i + 1) * per], eps[:, i * per:(i + 1) * per]) for i in range(n)]
    ref_loss, ref = _mean_reference(conv, shards, 1.0, dev)
    model = copy.deepcopy(conv).to(dev)
    st = _state(model)
    mesh = mesh_lib.make_mesh()
    mesh_lib.replicate_state(st, mesh)
    m = mesh_lib.make_dp_train_step(model, st.optimizer, mesh)(*shards[rank], 1.0)
    _report(deltas, "DP", float(m["loss"]), ref_loss, 1e-4, f" on {n} ranks")
    pd = _param_delta(model, ref)
    assert pd < 1e-5, f"DP updated params diverge from the reference by {pd}"
    deltas["DP params"] = pd

    # DP x TP: SetLRVAE, heads and FFN columns on 'model'
    if n >= 2 and n % 2 == 0:
        lrset = _build("setlrvae", "shapenet", SET)
        pts = _to(dev, torch.randn(2 * (n // 2), 32, 3,
                                   generator=torch.Generator().manual_seed(2)))[0]
        e2 = _to(dev, _noise((pts.shape[0], 8), 3))[0]
        ref_loss, _ = _mean_reference(lrset, [(pts, e2)], 1.0, dev)
        model = copy.deepcopy(lrset).to(dev)
        mesh = mesh_lib.make_mesh(n // 2, 2)
        st = tp.shard_state(_state(model, clip=False), mesh)
        step = tp.make_tp_dp_train_step(model, st.optimizer, mesh)
        m = step(mesh_lib.shard_batch(pts, mesh), mesh_lib.shard_batch(e2, mesh), 1.0)
        _report(deltas, "DPxTP", float(m["loss"]), ref_loss, 1e-3, f" on mesh {n // 2}x2")

    # DP x SP: SetLRVAE's points on 'seq', the rows' losses averaged
    if n >= 4 and n % 2 == 0:
        n_seq = n // 2
        lrset = _build("setlrvae", "shapenet", dict(SET, num_points=8 * n_seq))
        pts = _to(dev, torch.randn(4, 8 * n_seq, 3,
                                   generator=torch.Generator().manual_seed(4)))[0]
        block = _noise((2, 8), 5).to(dev)
        ref_loss, _ = _mean_reference(lrset, [(pts[:2], block), (pts[2:], block)], 1.0, dev)
        model = copy.deepcopy(lrset).to(dev)
        mesh = sp.make_sp_mesh(2, n_seq)
        st = _state(model, clip=False)
        mesh_lib.replicate_state(st, mesh)
        m = sp.make_sp_train_step(model, st.optimizer, mesh)(sp.shard_points(pts, mesh), block,
                                                             1.0)
        _report(deltas, "DPxSP", float(m["loss"]), ref_loss, 1e-3, f" on mesh 2x{n_seq}")

    # PP: the SetVAE encoder stack, one layer a stage, z = mu
    xpts = _to(dev, torch.randn(8, 32, 3, generator=torch.Generator().manual_seed(6)))[0]
    for name, n_data, n_stages, n_micro in (("PP", 1, n, 4), ("DPxPP", 2, n // 2, 2)):
        if n_data > 1 and n < 4:
            continue
        setvae = _build("setvae", "shapenet", dict(SET, num_encoder_layers=n_stages,
                                                   num_decoder_layers=1))
        ref_loss, _ = _mean_reference(setvae, [(xpts, None)], 1.0, dev)
        model = copy.deepcopy(setvae).to(dev)
        mesh = (pp_setvae.make_dp_pp_mesh(n_data, n_stages) if n_data > 1
                else pp.make_pp_mesh(n_stages))
        st = pp_setvae.shard_pp_setvae_state(_state(model, clip=False), mesh)
        step = pp_setvae.make_setvae_pp_train_step(model, st.optimizer, mesh, n_micro)
        m = step(mesh_lib.shard_batch(xpts, mesh), None, 1.0)
        _report(deltas, name, float(m["loss"]), ref_loss, 1e-4,
                f": SetVAE encoder stack, mesh {n_data}x{n_stages} (data x stage)")

    # EP: SetVAE with n MoE experts, one a rank; the capacity of the shard
    moe = _build("setvae", "shapenet", dict(SET, num_points=16, num_encoder_layers=1,
                                            num_decoder_layers=1, moe_experts=n))
    xe = _to(dev, torch.randn(2 * n, 16, 3, generator=torch.Generator().manual_seed(8)))[0]
    ee = _to(dev, _noise((2 * n, 8), 9))[0]
    ref_loss, _ = _mean_reference(
        moe, [(xe[2 * i:2 * i + 2], ee[2 * i:2 * i + 2]) for i in range(n)], 0.0, dev)
    model = copy.deepcopy(moe).to(dev)
    mesh = ep.make_ep_mesh(n)
    st = ep.shard_setvae_ep_state(_state(model, clip=False), mesh)
    step = ep.make_setvae_ep_train_step(model, st.optimizer, mesh)
    m = step(mesh_lib.shard_batch(xe, mesh, axis=ep.EXPERT_AXIS),
             mesh_lib.shard_batch(ee, mesh, axis=ep.EXPERT_AXIS), 0.0)
    _report(deltas, "EP", float(m["loss"]), ref_loss, 1e-3,
            f": SetVAE with {n}-expert MoE FFNs, one expert a rank")

    # FSDP: the conv LRVAE, its parameters and moments split over the ranks
    ref_loss, _ = _mean_reference(conv, [(x, eps)], 1.0, dev)
    model = copy.deepcopy(conv).to(dev)
    frac = fsdp.sharded_fraction(model, n, min_shard_elems=64)
    assert frac > 0.0, "the FSDP rule split nothing of the dry run's model"
    mesh = fsdp.make_fsdp_mesh(n)
    st = fsdp.shard_state(_state(model), mesh, min_shard_elems=64)
    step = fsdp.make_fsdp_train_step(model, st.optimizer, mesh, st.fsdp_params)
    m = step(mesh_lib.shard_batch(x, mesh), mesh_lib.shard_batch(eps, mesh, 1), 1.0)
    _report(deltas, "FSDP", float(m["loss"]), ref_loss, 1e-3,
            f": {frac:.0%} of the parameter elements split over {n} ranks")
    return deltas


def dryrun_multichip(n_ranks: int) -> dict:
    """Run the dry run on the open process group of n_ranks ranks (the
    launch's devices: CUDA under NCCL, else the CPU); returns {phase:
    parity delta}. Raises where a phase disagrees with its reference."""
    from vae_song_tpu_torch.parallel.mesh import device_type

    if dist.get_world_size() != n_ranks:
        raise ValueError(f"the dry run on {n_ranks} ranks runs in a group of "
                         f"{dist.get_world_size()}")
    dev = torch.device("cuda", torch.cuda.current_device()) if device_type() == "cuda" \
        else torch.device("cpu")
    return _body(n_ranks, dev)


def _spawn(n: int, device: str) -> int:
    """n rank processes of this module, one a card (NCCL) or, with
    device 'cpu', on the CPU (gloo); their exit code."""
    from vae_song_tpu_torch.parallel.mesh import _free_port

    env = dict(os.environ, MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-m", "vae_song_tpu_torch.parallel.dryrun",
                               "--ranks", str(n), "--device", device],
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r)))
             for r in range(n)]
    codes = [p.wait() for p in procs]
    return max(codes, key=abs)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="cuda: one NCCL rank a card (default); cpu: gloo ranks on the CPU")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to start (default: every visible card; 4 on the CPU)")
    args = ap.parse_args(argv)
    cards = torch.cuda.device_count()
    if "WORLD_SIZE" not in os.environ:
        n = args.ranks or (cards if args.device == "cuda" else 4)
        if args.device == "cuda" and (n < 1 or cards < n):
            print(f"the dry run on {n or 'the visible'} cards finds {cards} visible; "
                  "pass --device cpu for gloo ranks on the CPU", file=sys.stderr)
            return 2
        return _spawn(n, args.device)
    if args.device == "cuda" and not cards:
        print("the dry run's ranks find no card; pass --device cpu for gloo ranks on the CPU",
              file=sys.stderr)
        return 2
    from vae_song_tpu_torch.parallel.mesh import init_multihost

    torch.set_num_threads(1)
    _, world = init_multihost("nccl" if args.device == "cuda" else "gloo")
    try:
        dryrun_multichip(world)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
