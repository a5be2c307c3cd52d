"""Experiment CLI of the PyTorch port (port of vae_song_tpu/cli/main.py):

    python -m vae_song_tpu_torch.cli.main --config configs/config_pinwheel.yaml [--device cpu]
    python -m vae_song_tpu_torch.cli.main --config configs/config_shapenet_setvae.yaml \\
        --fake_data [--device cpu]

Loads the YAML, sweeps the hyperparameter grid of `experiment_type`
(lidvae, vae, nae, lrvae, setvae, setlrvae) and runs
`train_and_test` for every sweep point, with weights drawn from a CPU
torch.Generator seeded with the point's seed. `run_experiment` also
takes the config as a dict (the card's machine has no pyyaml).
`--resume_from` continues one point's run from a `ckpt_*.pkl` the port
wrote (refused for a sweep of more than one point); the config's
`common_params` keys `async_checkpoint` and `grad_accum` reach the
trainer as in the JAX CLI, and so do the `model_params` keys
`data_parallel` (or the `--data_parallel` flag), `fsdp` and
`tensor_parallel`, which train one process per device:

    torchrun --nproc_per_node N -m vae_song_tpu_torch.cli.main --config ...

Under torchrun the process group (NCCL on the card, gloo with `--device
cpu`) opens before anything else, and only rank 0 writes the result tree.
The device defaults to CUDA; `--device cpu` trains with the plain
PyTorch versions of the kernels.
"""

import argparse
import os

import torch

from vae_song_tpu_torch.config import load_config, resolve_names, sweep_grid
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.train.loop import train_and_test


def run_experiment(config, output_root: str = ".", seed: int = 42,
                   fake_data: bool = False, profile_dir: str | None = None,
                   resume_from: str | None = None, data_parallel: bool = False,
                   checkpoint_every: int | None = None, device="cuda"):
    """Every sweep point of `config` (a YAML path, or the dict it holds)
    through `train_and_test`; returns their summaries."""
    if not isinstance(config, dict):
        config = load_config(config)
    exp_type = config["experiment_type"]
    common = config["common_params"]
    mp = config["model_params"]
    logfilename, resultname = resolve_names(config)
    dataset_params = dict(common.get("dataset_params") or {})
    if fake_data:
        dataset_params["fake"] = True

    points = list(sweep_grid(config))
    if resume_from is not None and len(points) > 1:
        raise ValueError(
            f"--resume_from with a {len(points)}-point sweep grid would restore "
            f"one checkpoint (trained under a single hyperparameter setting) "
            f"into every grid cell; narrow the config to the cell being resumed."
        )

    results = []
    for point in points:
        point_seed = seed + point["rep"]
        model = build_model(
            exp_type, common["exp_data"], mp, beta=point["beta"], alpha=point["alpha"],
            il=point["il"], generator=torch.Generator().manual_seed(point_seed),
        )
        _, summary = train_and_test(
            model,
            epochs=common["exp_epochs"],
            batch_size=common["batch_size"],
            dataset_name=common["exp_data"],
            logfilename=logfilename,
            resultname=resultname,
            pt_param=common.get("pt_param"),
            num_mc_samples=mp.get("num_mc_samples", 1),
            grad_clip=common.get("grad_clip"),
            wu_strat=common.get("wu_strat", "linear"),
            seed=point_seed,
            dataset_params=dataset_params,
            output_root=output_root,
            profile_dir=profile_dir,
            resume_from=resume_from,
            data_parallel=data_parallel or bool(mp.get("data_parallel", False)),
            checkpoint_every=checkpoint_every,
            native_prefetch=bool(common.get("native_prefetch", False)),
            pipeline_parallel=int(mp.get("pipeline_parallel", 0)),
            expert_parallel=bool(mp.get("expert_parallel", False)),
            tensor_parallel=int(mp.get("tensor_parallel", 0)),
            sequence_parallel=int(mp.get("sequence_parallel", 0)),
            sequence_parallel_ring=bool(mp.get("sequence_parallel_ring", False)),
            fsdp=bool(mp.get("fsdp", False)),
            async_checkpoint=bool(common.get("async_checkpoint", False)),
            grad_accum=int(common.get("grad_accum", 0)),
            device=device,
        )
        results.append(summary)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description="vae_song_tpu_torch experiment CLI")
    parser.add_argument("--config", type=str,
                        default="./configs/config_shapenet_setvae.yaml",
                        help="config file path")
    parser.add_argument("--output_root", type=str, default=".")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--fake_data", action="store_true",
                        help="use synthetic stand-in clouds instead of a dataset directory")
    parser.add_argument("--device", type=str, default="cuda", choices=["cpu", "cuda"])
    parser.add_argument("--profile_dir", type=str, default=None)
    parser.add_argument("--resume_from", type=str, default=None)
    parser.add_argument("--data_parallel", action="store_true")
    parser.add_argument("--checkpoint_every", type=int, default=None)
    args = parser.parse_args(argv)
    if "RANK" in os.environ:
        # launched by torchrun: one process per device, the group opened
        # before any model moves (a failure ends the run with its error)
        from vae_song_tpu_torch.parallel.mesh import init_multihost

        rank, world = init_multihost("nccl" if args.device == "cuda" else "gloo")
        print(f"process group: rank {rank} of {world}", flush=True)
    return run_experiment(args.config, args.output_root, args.seed, args.fake_data,
                          args.profile_dir, args.resume_from, args.data_parallel,
                          args.checkpoint_every, args.device)


if __name__ == "__main__":
    main()
