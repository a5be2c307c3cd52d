"""The JAX package's vae_song_tpu/parallel (port), under its names:

  * mesh.py: process groups (one process per device, torchrun), device
    meshes, data parallelism (DistributedDataParallel);
  * fsdp.py: FSDP / ZeRO-3 (FSDP2 `fully_shard`) and TP x FSDP;
  * tp.py: tensor parallelism (DTensor `parallelize_module`);
  * sp.py: sequence parallelism (the point axis on 'seq': all-gather or
    ring attention, the sharded pool, query slices and Chamfer) and
    DP x SP;
  * pp.py: GPipe over a 'stage' group (point-to-point hand-offs inside
    autograd Functions); pp_setvae.py: the set models' encoder layers as
    stages, and DP x PP;
  * ep.py: the MoE FFN's routing on one device, and expert parallelism
    (one expert a rank, tokens exchanged by all_to_all);
  * optree.py: the optimizer state laid out like the parameters, the
    clip over sharded gradients, the step TP and FSDP share;
  * dryrun.py: every strategy for one step against its reference
    (`python -m vae_song_tpu_torch.parallel.dryrun`);
  * sweep.py: the Lipschitz sweep runner.

The differentiable collectives they use are nn/collectives.py's. The
submodules import torch.distributed's wrappers inside their functions."""

from vae_song_tpu_torch.parallel.ep import (
    make_ep_apply,
    make_ep_mesh,
    make_ep_train_step,
    make_setvae_ep_eval_step,
    make_setvae_ep_train_step,
    moe_ffn_ep,
    setvae_ep_specs,
    shard_moe,
    shard_moe_opt,
    shard_setvae_ep_state,
)
from vae_song_tpu_torch.parallel.fsdp import (
    fsdp_param_specs,
    make_fsdp_mesh,
    make_fsdp_train_step,
    make_tp_fsdp_train_step,
    merge_tp_fsdp_specs,
    shard_state as fsdp_shard_state,
    shard_state_tp_fsdp,
    sharded_fraction,
)
from vae_song_tpu_torch.parallel.mesh import (
    init_multihost,
    make_dp_eval_step,
    make_dp_train_step,
    make_mesh,
    replicate_state,
    shard_batch,
)
from vae_song_tpu_torch.parallel.pp import (
    make_pp_apply,
    make_pp_mesh,
    make_pp_train_step,
    scan_blocks,
    shard_pp_state,
    stack_block_params,
)
from vae_song_tpu_torch.parallel.pp_setvae import (
    make_dp_pp_mesh,
    make_setvae_pp_train_step,
    merge_opt_state,
    merge_params,
    pp_param_specs,
    pp_sync,
    shard_pp_setvae_state,
    split_opt_state,
    split_params,
)
from vae_song_tpu_torch.parallel.sp import (
    make_sp_eval_step,
    make_sp_mesh,
    make_sp_train_step,
    shard_points,
)
from vae_song_tpu_torch.parallel.tp import (
    check_flash_partitionable,
    check_tp_coverage,
    make_tp_dp_train_step,
    setvae_param_specs,
    shard_state as tp_shard_state,
)

__all__ = [
    "init_multihost",
    "make_mesh",
    "replicate_state",
    "shard_batch",
    "make_dp_train_step",
    "make_dp_eval_step",
    "fsdp_param_specs",
    "make_fsdp_mesh",
    "make_fsdp_train_step",
    "make_tp_fsdp_train_step",
    "merge_tp_fsdp_specs",
    "fsdp_shard_state",
    "shard_state_tp_fsdp",
    "sharded_fraction",
    "check_flash_partitionable",
    "check_tp_coverage",
    "make_tp_dp_train_step",
    "setvae_param_specs",
    "tp_shard_state",
    "make_sp_mesh",
    "shard_points",
    "make_sp_train_step",
    "make_sp_eval_step",
    "make_pp_mesh",
    "make_pp_apply",
    "make_pp_train_step",
    "stack_block_params",
    "scan_blocks",
    "shard_pp_state",
    "make_dp_pp_mesh",
    "split_params",
    "merge_params",
    "split_opt_state",
    "merge_opt_state",
    "pp_param_specs",
    "shard_pp_setvae_state",
    "make_setvae_pp_train_step",
    "pp_sync",
    "make_ep_mesh",
    "moe_ffn_ep",
    "shard_moe",
    "make_ep_apply",
    "shard_moe_opt",
    "make_ep_train_step",
    "setvae_ep_specs",
    "shard_setvae_ep_state",
    "make_setvae_ep_train_step",
    "make_setvae_ep_eval_step",
]
