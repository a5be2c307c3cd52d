"""The JAX package's vae_song_tpu/parallel (port), under its names:

  * mesh.py: process groups (one process per device, torchrun), device
    meshes, data parallelism (DistributedDataParallel);
  * fsdp.py: FSDP / ZeRO-3 (FSDP2 `fully_shard`) and TP x FSDP;
  * tp.py: tensor parallelism (DTensor `parallelize_module`);
  * optree.py: the optimizer state laid out like the parameters, the
    clip over sharded gradients, the step TP and FSDP share;
  * sweep.py: the Lipschitz sweep runner; ep.py: the MoE FFN's routing
    on one device.

Sequence, pipeline and multi-device expert parallelism wait for
ROADMAP.md Queue 1 item 15b. The submodules import torch.distributed's
wrappers inside their functions."""

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
]
