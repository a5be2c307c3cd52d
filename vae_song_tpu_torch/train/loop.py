"""End-to-end train/eval loop on one device for the set models, the
FlexibleVAE family and LIDVAE (port of vae_song_tpu/train/loop.py:train_and_test,
its single-device branch with per-batch steps, :802-1009 and
:1016-1096).

Per epoch: the warmup alpha (the models that set `has_warmup`: LRVAE,
SetLRVAE), one train step per shuffled batch (or, with `grad_accum`, one
optimizer update per batch from that many microbatches), the dataset's
augment applied to each training batch on the device (MNIST's rotation
and crop, CIFAR-10's and CelebA's flip), the eval step over the test split
(in the order of the pipeline, shuffled for the 1-D datasets as JAX's
dispatched loop does), TensorBoard scalars and the progress line, and with
`checkpoint_every` the full train state at `params/ckpt_{epoch}.pkl`
(optionally written by the AsyncCheckpointer's worker thread). With
`native_prefetch` the training batches come from the native loader's C++
threads (data/native.py), seeded from the epoch's numpy Generator as in
JAX. At the last epoch: `params/model_{epoch}.pkl` in the JAX package's
format, and the set models' `.ply`/`.npy` point-cloud dumps, or for the
other models, from the last eval batch, the 1-D datasets' five
`scatter2d/{epoch}_{input,mu,z,recon,sample}.png` plots or the images'
four `valontr/{epoch}_{origin,recon,recon_wos,sample}.png` grids, and the
`pca/` plots of mu and z (matplotlib is imported there; without it the run
prints which plots it did not write and goes on). At the end: the
posterior metrics on one batch of 50 test samples, the experiment log and
the unified CSV row. `resume_from` continues a run from such a checkpoint
at the next epoch. Generation-only mode (`epochs < 0`, main.py:323-360)
trains nothing: it decodes 50 batches of z ~ N(0, I) from the model (its
`pt_param` checkpoint), writes one PNG an image under `generation/`, and
scores them against the test images with the FID (ops/fid.py) on the
device, which the CSV row carries. The artifact tree is the JAX
trainer's:

    <output_root>/results/<resultname>/<run name>/{log.txt, params/, point_clouds/,
        scatter2d/, valontr/, pca/, generation/}
    <output_root>/runs/<run name>/events.out.tfevents.*
    <output_root>/log/<logfilename>

The FlexibleVAE family trains with L = num_mc_samples Monte-Carlo
latents a step and evaluates with L = 1, as JAX does; the set models
and LIDVAE (single-sample in JAX too) take one latent a step.

Randomness: the batch order is the JAX pipeline's (a numpy Generator
seeded with [seed, epoch]); the reparameterisation noise and the augment's
draws, which JAX takes from its own PRNG, come from CPU torch.Generators
seeded from (seed, epoch, stream), so they do not depend on the device.
The training-dropout masks come from a generator on the training device
seeded the same way (a [64, 4, 2048, 2048] mask a layer cannot be drawn
on the host every step), so a run with attn_dropout > 0 depends on the
device: the card's and the CPU's streams differ. Per-epoch seeding
makes a resumed run replay the continuous one. The JAX package's
multistep and scanned dispatch paths are TPU machinery and have no
counterpart. The parallel strategies (`data_parallel`, `fsdp`,
`tensor_parallel`, `sequence_parallel`, `pipeline_parallel`,
`expert_parallel` and their compositions, parallel/) run one process per
device (torchrun; without it a one-process group): every rank iterates
the same global batches and noise and takes its block of them; only rank
0 writes the result tree; checkpoints and the last epoch's export are
gathered whole into the single-device format (under pipeline parallelism
after every layer and its Adam moments reached every rank), so they load
under any strategy. With `profile_dir` the training steps of epoch 1
(epoch 0 holds the first calls) run under torch.profiler
(train/profiling.py:trace), which writes their trace there.
"""

import copy
import os
import shutil
import sys
import tempfile
import time
from contextlib import nullcontext
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from vae_song_tpu_torch import data as data_lib
from vae_song_tpu_torch.data.pipeline import iterate_batches, num_batches
from vae_song_tpu_torch.models.flexible import FlexibleVAE
from vae_song_tpu_torch.models.lidvae import LIDVAE
from vae_song_tpu_torch.models.setvae import SetEncoderAttn, SetVAE
from vae_song_tpu_torch.nn.sync import full_tensor
from vae_song_tpu_torch.ops import fid as fid_lib
from vae_song_tpu_torch.ops import metrics as metrics_lib
from vae_song_tpu_torch.ops.warmup import warmup_alpha
from vae_song_tpu_torch.parallel.mesh import data_coordinate, init_multihost
from vae_song_tpu_torch.train import checkpoint as ckpt_lib
from vae_song_tpu_torch.train import loggers
from vae_song_tpu_torch.train.profiling import trace
from vae_song_tpu_torch.train.state import TrainState, make_optimizer
from vae_song_tpu_torch.train.steps import (make_accum_train_step, make_apply_fns,
                                             make_eval_step)
from vae_song_tpu_torch.viz.pca import pca_visualization
from vae_song_tpu_torch.viz.plots import (save_image_grid, save_point_cloud,
                                          visualize_2c_points_on_image)

_METRICS = ("loss", "recon", "reg", "lr")
# random streams of one run
_TRAIN, _EVAL, _FINAL, _DUMP, _DROPOUT, _AUGMENT, _GENERATE = range(7)
# generation-only mode decodes this many batches (main.py:326)
SAMPLE_ITERATION = 50


def synth_run_name(model, alpha=None) -> str:
    """Run-name synthesis (main.py:211-219)."""
    name = type(model).__name__ + datetime.now().strftime(" %m%d%H%M")
    if not type(model).__name__.startswith("NaiveAE"):
        name += "_b=" + str(float(model.beta))
    if type(model).__name__.startswith(("LR", "SetLR")):
        name += "_a=" + str(model.alpha if alpha is None else alpha)
    if getattr(model, "is_log_mse", False):
        name += "_logmse"
    if type(model).__name__ == "LIDVAE":
        name += "_il=" + str(float(model.inverse_lipschitz) / 2.0)
    return name


def _generator(seed: int, *stream: int, device="cpu") -> torch.Generator:
    """Generator on `device` seeded from (seed, *stream) through numpy's
    SeedSequence."""
    state = np.random.SeedSequence([seed, *stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def _compute_fid(test_ds, generated: np.ndarray, device, chunk: int = 256) -> float:
    """FID between the first 5000 test images and the generated ones
    (main.py:349-360 analogue), the features computed on `device`:
    InceptionV3 pool3 with $VST_FID_WEIGHTS (pytorch_fid-comparable), else
    the seeded random-conv features (comparable between runs of either
    package, not to Inception-FID)."""
    real = np.asarray(test_ds.X[:5000], np.float32)
    extractor, is_inception = fid_lib.default_extractor(real.shape[1:], seed=0, device=device)

    def chunks(a):
        for i in range(0, len(a), chunk):
            yield a[i:i + chunk]

    score = fid_lib.fid_score(extractor, chunks(real), chunks(generated))
    tag = ("InceptionV3 pool3, $VST_FID_WEIGHTS — pytorch_fid-comparable"
           if is_inception else "seeded random-conv features, non-Inception")
    print(f"FID ({tag}): {score:.4f}")
    return score


def _check_strategies(model, *, data_parallel, pipeline_parallel, expert_parallel,
                      tensor_parallel, sequence_parallel, sequence_parallel_ring, fsdp,
                      grad_accum):
    """The JAX trainer's strategy guards (its :210-255), with its
    conditions and messages."""
    if not isinstance(model, (SetVAE, FlexibleVAE, LIDVAE)):
        raise TypeError(
            f"train_and_test trains the set models, the FlexibleVAE family and LIDVAE; "
            f"got {type(model).__name__}"
        )
    active = [name for name, on in (
        ("pipeline_parallel", (pipeline_parallel or 0) > 1),
        ("expert_parallel", expert_parallel),
        ("tensor_parallel", (tensor_parallel or 0) > 1),
        ("sequence_parallel", (sequence_parallel or 0) > 1),
    ) if on]
    if len(active) > 1:
        raise ValueError(
            f"{' and '.join(active)} are exclusive (each owns "
            "the device mesh; compose with data_parallel instead)"
        )
    if fsdp and active and active != ["tensor_parallel"]:
        raise ValueError(
            f"fsdp and {active[0]} are exclusive (fsdp composes "
            "only with tensor_parallel: 2-D data x model weight sharding)"
        )
    if grad_accum and grad_accum > 1 and (active or fsdp or data_parallel):
        raise ValueError(
            "grad_accum is the single-device microbatching path; it does "
            "not compose with the parallel strategies (shard the batch "
            "instead)"
        )
    if sequence_parallel_ring and not (sequence_parallel and sequence_parallel > 1):
        raise ValueError(
            "sequence_parallel_ring selects the ring variant OF sequence "
            f"parallelism; it requires sequence_parallel >= 2 (got "
            f"{sequence_parallel})"
        )


def _world_size() -> int:
    """Ranks of the open process group, else of the torchrun launch."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ.get("WORLD_SIZE", 1))


def _launch_check(world: int, n: int) -> None:
    if world != n:
        raise ValueError(
            f"the mesh holds {n} ranks but {world} processes were "
            f"launched; launch it with torchrun --nproc_per_node {n}"
        )


def _mesh_shape(model, *, data_parallel, tensor_parallel, fsdp, batch_size,
                pipeline_parallel=0, expert_parallel=False, sequence_parallel=0):
    """The mesh of the strategy asked for, after the JAX trainer's checks of
    its PP (:349-412), EP (:440-467), TP (:479-520), SP (:551-577), FSDP
    (:593-602) and DP branches: (n_data, n_inner), the inner dimension
    'stage', 'expert', 'model' or 'seq' (1 for DP and FSDP); the launch
    must hold exactly that many ranks."""
    world = _world_size()
    if pipeline_parallel and pipeline_parallel > 1:
        from vae_song_tpu_torch.parallel.pp_setvae import _check_pp_model

        if world < pipeline_parallel:
            raise ValueError(
                f"pipeline_parallel={pipeline_parallel} needs that many "
                f"devices; have {world}"
            )
        n_data = world // pipeline_parallel if data_parallel else 1
        if data_parallel and n_data < 2:
            raise ValueError(
                f"data_parallel x pipeline_parallel={pipeline_parallel} "
                f"needs >= {2 * pipeline_parallel} devices; have {world}"
            )
        if batch_size % n_data != 0:
            raise ValueError(
                f"batch_size={batch_size} must divide over {n_data} "
                "data-parallel pipelines"
            )
        _check_pp_model(model)
        n_layers = len(model.encoder.layers)
        if n_layers % pipeline_parallel != 0:
            raise ValueError(
                f"{n_layers} encoder layers do not divide over {pipeline_parallel} stages"
            )
        _launch_check(world, n_data * pipeline_parallel)
        return n_data, pipeline_parallel
    if expert_parallel:
        n_exp = int(getattr(model, "moe_experts", 0))
        if data_parallel:
            raise ValueError("expert_parallel and data_parallel are exclusive")
        if n_exp < 2:
            raise ValueError(
                "expert_parallel needs a MoE set model (model_params key "
                f"moe_experts >= 2; got {n_exp})"
            )
        if world < n_exp:
            raise ValueError(
                f"expert_parallel needs moe_experts={n_exp} devices; "
                f"have {world}"
            )
        if batch_size % n_exp != 0:
            raise ValueError(
                f"batch_size={batch_size} must divide over {n_exp} experts"
            )
        _launch_check(world, n_exp)
        return 1, n_exp
    if sequence_parallel and sequence_parallel > 1:
        from vae_song_tpu_torch.parallel.sp import _validate

        if getattr(model, "data_type", None) != "set":
            raise ValueError(
                "sequence_parallel shards the POINT axis of the attention "
                f"set models (parallel/sp.py); got {type(model).__name__}"
            )
        n_data = world // sequence_parallel if data_parallel else 1
        if data_parallel and n_data < 2:
            raise ValueError(
                f"data_parallel x sequence_parallel={sequence_parallel} "
                f"needs >= {2 * sequence_parallel} devices; have {world}"
            )
        if world < n_data * sequence_parallel:
            raise ValueError(
                f"sequence_parallel={sequence_parallel} needs that many "
                f"devices; have {world}"
            )
        if batch_size % n_data != 0:
            raise ValueError(
                f"batch_size={batch_size} must divide over {n_data} "
                "data-parallel shards"
            )
        _validate(model, sequence_parallel)
        _launch_check(world, n_data * sequence_parallel)
        return n_data, sequence_parallel
    if tensor_parallel and tensor_parallel > 1:
        if getattr(model, "data_type", None) != "set" or not isinstance(
                getattr(model, "encoder", None), SetEncoderAttn):
            raise ValueError(
                "tensor_parallel targets the attention set models "
                "(Megatron-style head/FFN sharding, parallel/tp.py); "
                f"got {type(model).__name__}"
            )
        n_data = world // tensor_parallel if (data_parallel or fsdp) else 1
        if (data_parallel or fsdp) and n_data < 2:
            raise ValueError(
                f"{'fsdp' if fsdp else 'data_parallel'} x tensor_parallel="
                f"{tensor_parallel} needs >= {2 * tensor_parallel} devices; "
                f"have {world}"
            )
        if world < n_data * tensor_parallel:
            raise ValueError(
                f"tensor_parallel={tensor_parallel} needs that many "
                f"devices; have {world}"
            )
        heads = model.encoder.layers[0].self_attn.num_heads
        if heads % tensor_parallel != 0:
            raise ValueError(
                f"num_heads={heads} must divide over "
                f"tensor_parallel={tensor_parallel} 'model' shards"
            )
        shape = (n_data, tensor_parallel)
    else:
        shape = (world, 1)
    if batch_size % shape[0] != 0:
        kind = "fsdp batch" if fsdp and shape[1] == 1 else "data-parallel"
        raise ValueError(f"batch_size={batch_size} must divide over {shape[0]} {kind} shards")
    _launch_check(world, shape[0] * shape[1])
    return shape


class _Strategy:
    """What the trainer runs under a strategy: the train and eval steps,
    the mesh, how a global batch is cut for each (`shard_train`,
    `shard_eval`: (tensor, dim) -> this rank's block), the mesh
    dimension whose ranks draw their own dropout masks, and `sync`
    (state, with_opt) -> state, which makes the model whole on every
    rank before the eval, a checkpoint or the exports (pipeline
    parallelism), else None."""

    def __init__(self, state, train_step, eval_step, mesh, batch_axis="data",
                 shard_train=None, shard_eval=None, sync=None):
        from vae_song_tpu_torch.parallel.mesh import shard_batch

        def by_batch(t, dim=0):
            return shard_batch(t, mesh, dim, batch_axis)

        self.state, self.train_step, self.eval_step, self.mesh = state, train_step, eval_step, mesh
        self.batch_axis, self.sync = batch_axis, sync
        self.shard_train = shard_train or by_batch
        self.shard_eval = shard_eval or by_batch


def _setup_strategy(state, shape, *, data_parallel, tensor_parallel, fsdp, batch_size,
                    pipeline_parallel=0, expert_parallel=False, sequence_parallel=0,
                    sequence_parallel_ring=False):
    """The _Strategy asked for on a mesh of `shape`, the state sharded as
    it says."""
    from vae_song_tpu_torch.parallel import fsdp as fsdp_lib
    from vae_song_tpu_torch.parallel import mesh as mesh_lib
    from vae_song_tpu_torch.parallel import optree
    from vae_song_tpu_torch.parallel import tp as tp_lib

    model = state.model
    if pipeline_parallel and pipeline_parallel > 1:
        from vae_song_tpu_torch.parallel import pp, pp_setvae

        mesh = pp_setvae.make_dp_pp_mesh(*shape) if shape[0] > 1 else pp.make_pp_mesh(shape[1])
        state = pp_setvae.shard_pp_setvae_state(state, mesh)
        n_micro = pp_setvae.default_n_micro(batch_size // shape[0], pipeline_parallel)
        step = pp_setvae.make_setvae_pp_train_step(model, state.optimizer, mesh, n_micro)

        def sync(st, with_opt=False):
            return pp_setvae.pp_sync(st, mesh, with_opt)

        # every rank evaluates the whole batch on the whole model (JAX :437)
        return _Strategy(state, lambda x, eps, wu, rng=None: step(x, eps, wu),
                         make_eval_step(model), mesh, sync=sync,
                         shard_eval=lambda t, dim=0: t)
    if expert_parallel:
        from vae_song_tpu_torch.parallel import ep

        mesh = ep.make_ep_mesh(shape[1])
        state = ep.shard_setvae_ep_state(state, mesh)
        return _Strategy(state, ep.make_setvae_ep_train_step(model, state.optimizer, mesh),
                         ep.make_setvae_ep_eval_step(model, mesh), mesh,
                         batch_axis=ep.EXPERT_AXIS)
    if sequence_parallel and sequence_parallel > 1:
        from vae_song_tpu_torch.parallel import sp

        mesh = sp.make_sp_mesh(*shape)
        mesh_lib.replicate_state(state, mesh)

        def points(t, dim=0):
            # the clouds by row and point shard, the noise by row
            return sp.shard_points(t, mesh) if t.dim() == 3 else mesh_lib.shard_batch(t, mesh, dim)

        return _Strategy(state, sp.make_sp_train_step(model, state.optimizer, mesh,
                                                      sequence_parallel_ring),
                         sp.make_sp_eval_step(model, mesh, sequence_parallel_ring), mesh,
                         shard_train=points, shard_eval=points)
    mesh = mesh_lib.make_mesh(*shape)
    if tensor_parallel and tensor_parallel > 1:
        tp_lib.check_flash_partitionable(model, mesh)
        if fsdp:
            state = fsdp_lib.shard_state_tp_fsdp(state, mesh)
            step = fsdp_lib.make_tp_fsdp_train_step(model, state.optimizer, mesh,
                                                    state.fsdp_params)
        else:
            state = tp_lib.shard_state(state, mesh)
            step = tp_lib.make_tp_dp_train_step(model, state.optimizer, mesh)
    elif fsdp:
        state = fsdp_lib.shard_state(state, mesh)
        step = fsdp_lib.make_fsdp_train_step(model, state.optimizer, mesh, state.fsdp_params)
    else:
        mesh_lib.replicate_state(state, mesh)
        return _Strategy(state, mesh_lib.make_dp_train_step(model, state.optimizer, mesh),
                         mesh_lib.make_dp_eval_step(model, mesh), mesh)
    return _Strategy(state, step, optree.make_gspmd_eval_step(model, mesh), mesh)


def _device_name(device: torch.device) -> str:
    if device.type == "cuda":
        return f"{device} ({torch.cuda.get_device_name(device)})"
    return str(device)


def _noise(shape, generator, device) -> torch.Tensor:
    """N(0, 1) noise of `shape` drawn on the CPU from `generator`, on `device`."""
    return torch.randn(*shape, generator=generator).to(device)


def _means(ms: list[dict]) -> dict:
    """Per-key means of a list of metric dicts of 0-dim tensors, fetched
    to the host once per key."""
    if not ms:
        return {k: 0.0 for k in _METRICS}
    return {k: float(torch.stack([m[k] for m in ms]).float().mean()) for k in ms[0]}


def train_and_test(
    model,
    epochs: int = 100,
    batch_size: int = 128,
    dataset_name: str = "mnist",
    logfilename: str = "log.csv",
    resultname: str = "res",
    pt_param: str | None = None,
    num_mc_samples: int = 1,
    grad_clip: dict | None = None,
    wu_strat: str = "linear",
    seed: int = 42,
    dataset_params: dict | None = None,
    output_root: str = ".",
    lr: float = 1e-2,
    use_cosine: bool = True,
    visualize_artifacts: bool = True,
    checkpoint_every: int | None = None,
    progress: bool = True,
    profile_dir: str | None = None,
    resume_from: str | None = None,
    data_parallel: bool = False,
    native_prefetch: bool = False,
    pipeline_parallel: int = 0,
    expert_parallel: bool = False,
    tensor_parallel: int = 0,
    sequence_parallel: int = 0,
    sequence_parallel_ring: bool = False,
    fsdp: bool = False,
    async_checkpoint: bool = False,
    grad_accum: int = 0,
    device="cuda",
):
    """Train `model` (a set model, a FlexibleVAE or LIDVAE, moved to `device`) and
    evaluate it every epoch; returns (TrainState, summary dict). The
    arguments keep the JAX function's names and defaults. `num_mc_samples`
    is the FlexibleVAE train step's L; as in JAX, it does not change the
    set models' or LIDVAE's step (L = 1).

    use_cosine: the learning rate follows the cosine decay over the run's
    steps; False keeps it at `lr`.
    visualize_artifacts: write the last epoch's plots, grids and
    point-cloud dumps; False writes none of them.
    progress: print the progress line every epochs // 20 epochs and at
    the last.
    profile_dir: trace epoch 1's training steps into this directory.

    checkpoint_every: write the full train state to
    `params/ckpt_{epoch}.pkl` after every that many epochs, with the
    warmup state (`wu_alpha`, `last_kl`) as its `extra`.
    async_checkpoint: write those on the AsyncCheckpointer's worker
    thread; a failed write warns at the end instead of raising.
    resume_from: a `checkpoint_every` file; training continues at its
    epoch + 1 with its parameters, BatchNorm statistics, Adam state,
    step and warmup state, and replays the continuous run.
    grad_accum: >= 2 takes each optimizer update from that many
    sequential microbatches of the batch (`make_accum_train_step`);
    `batch_size` must divide by it.
    native_prefetch: assemble the training batches on the native loader's
    C++ threads (data/native.py:NativeBatchLoader); its shuffle is the
    library's, so the batch order differs from a run without it (as in
    JAX); without the library it takes the numpy path, as in JAX.
    epochs < 0: generation-only mode (the module's docstring); image
    datasets only, since it writes image PNGs and an image FID.

    The strategies (JAX's guards hold: one of pipeline, expert, tensor and
    sequence parallelism at a time; fsdp composes only with
    tensor_parallel, data_parallel with all but expert_parallel;
    grad_accum with none; the launch holds exactly the mesh's ranks):
    data_parallel: DistributedDataParallel over every rank, the JAX DP
    step's per-shard semantics (parallel/mesh.py); on one device it warns
    and trains single-device.
    fsdp: FSDP2 over every rank, any model family, the single-device
    step's semantics on the global batch (parallel/fsdp.py).
    tensor_parallel: >= 2 splits the attention set models' heads and FFN
    columns over that many ranks (parallel/tp.py); with data_parallel or
    fsdp on a (ranks // tensor_parallel) x tensor_parallel mesh.
    sequence_parallel: >= 2 shards the attention set models' points over
    that many ranks (parallel/sp.py), by all-gather attention or with
    sequence_parallel_ring the ring; with data_parallel on a (ranks //
    sequence_parallel) x sequence_parallel mesh.
    pipeline_parallel: >= 2 runs the attention set models' encoder layers
    as that many GPipe stages (parallel/pp_setvae.py), the smallest
    multiple of the stages dividing a pipeline's batch as its
    microbatches (else 1); with data_parallel one pipeline a 'data' row;
    the eval runs on the whole model on every rank.
    expert_parallel: the MoE set models (moe_experts >= 2) with one expert
    a rank (parallel/ep.py), the batch split over the experts' ranks.
    Pipeline and expert parallelism clip in their steps (the true global
    norm over the split gradients); the optimizer keeps its clip
    setting."""
    _check_strategies(
        model, data_parallel=data_parallel, pipeline_parallel=pipeline_parallel,
        expert_parallel=expert_parallel, tensor_parallel=tensor_parallel,
        sequence_parallel=sequence_parallel, sequence_parallel_ring=sequence_parallel_ring,
        fsdp=fsdp, grad_accum=grad_accum,
    )
    if data_parallel and not fsdp and not any(
            (k or 0) > 1 for k in (tensor_parallel, pipeline_parallel, sequence_parallel)) \
            and _world_size() == 1:
        # training single-device while the caller believes it measured DP
        # would be worse than a loud downgrade (JAX :322-332)
        print("WARNING: data_parallel requested but only 1 device is "
              "visible; training single-device", flush=True)
        data_parallel = False
    strategies = dict(pipeline_parallel=pipeline_parallel, expert_parallel=expert_parallel,
                      sequence_parallel=sequence_parallel)
    sharded = (data_parallel or fsdp or expert_parallel or any(
        (k or 0) > 1 for k in (tensor_parallel, pipeline_parallel, sequence_parallel)))
    owns_group = sharded and not dist.is_initialized()
    if sharded:
        mesh_shape = _mesh_shape(model, data_parallel=data_parallel,
                                 tensor_parallel=tensor_parallel, fsdp=fsdp,
                                 batch_size=batch_size, **strategies)
        # before the model moves: on the card each rank takes its own device;
        # the backend follows the device asked for, not the cards visible
        init_multihost("nccl" if torch.device(device).type == "cuda" else "gloo")
    if grad_accum and grad_accum > 1 and batch_size % grad_accum != 0:
        raise ValueError(
            f"batch_size={batch_size} must divide over "
            f"grad_accum={grad_accum} microbatches"
        )
    device = torch.device(device)
    train_ds, test_ds, augment = data_lib.load_dataset(dataset_name, **(dataset_params or {}))
    is_set = getattr(model, "data_type", None) == "set"
    data_type = "set" if is_set else "1d" if dataset_name in ("pinwheel", "chessboard") else "2d"
    is_image = not is_set and train_ds.X.ndim == 4
    if epochs < 0 and not is_image:
        raise ValueError(
            f"generation-only mode (epochs < 0) writes image PNGs and an image FID; "
            f"{dataset_name!r} is not an image dataset")
    n_samples = 1 if is_set or isinstance(model, LIDVAE) else num_mc_samples
    steps_per_epoch = num_batches(train_ds, batch_size)
    if steps_per_epoch == 0:
        raise ValueError("Dataset smaller than one batch")

    if pt_param is not None:
        if not os.path.exists(pt_param):
            raise FileNotFoundError(f"No such file: {pt_param}")
        ckpt_lib.load_params_only(pt_param, model)
    model.to(device)
    optimizer = make_optimizer(
        model.parameters(), lr=lr,
        total_steps=max(1, epochs * steps_per_epoch) if use_cosine else None,
        grad_clip=grad_clip,
    )
    state = TrainState(model, optimizer)

    start_epoch, resume_extra = 0, {}
    if resume_from is not None:
        state, ckpt_epoch, resume_extra = ckpt_lib.load_checkpoint(resume_from, state)
        start_epoch = ckpt_epoch + 1

    # under a process group only rank 0 writes the result tree; the others
    # write to a throwaway directory, removed at the end, so the loggers
    # stay callable without file races (JAX :285-295)
    is_main = not sharded or dist.get_rank() == 0
    if not is_main:
        output_root = tempfile.mkdtemp(prefix=f"vst_rank{dist.get_rank()}_")
    name = synth_run_name(model)
    result_dir = os.path.join(output_root, "results", resultname, name)
    os.makedirs(os.path.join(result_dir, "params"), exist_ok=True)
    writer = loggers.TensorBoardWriter(os.path.join(output_root, "runs", name))
    explog = loggers.create_experiment_logger(result_dir, name)
    explog.log_hyperparameters(
        epochs=epochs, batch_size=batch_size, device=_device_name(device),
        dataset_name=dataset_name, num_mc_samples=n_samples, wu_strat=wu_strat,
        grad_clip=grad_clip,
    )
    explog.log_model_info(model)

    train_step = make_accum_train_step(model, optimizer, max(1, grad_accum or 1))
    eval_step = make_eval_step(model)
    latent = model.latent_channel
    mesh, plain, strategy = None, model, None
    if sharded:
        # FSDP, TP and EP split the parameters: the last epoch's exports,
        # plots and the final metrics run on a whole copy, gathered from them
        if fsdp or expert_parallel or (tensor_parallel and tensor_parallel > 1):
            plain = copy.deepcopy(model)
        strategy = _setup_strategy(state, mesh_shape, data_parallel=data_parallel,
                                   tensor_parallel=tensor_parallel, fsdp=fsdp,
                                   batch_size=batch_size,
                                   sequence_parallel_ring=sequence_parallel_ring,
                                   **strategies)
        state, train_step, eval_step, mesh = (strategy.state, strategy.train_step,
                                              strategy.eval_step, strategy.mesh)
    encode_fn, decode_fn, forward_fn = make_apply_fns(plain)

    def gather_plain():
        """The whole parameters on `plain` (a collective under FSDP / TP)."""
        if plain is not model:
            plain.load_state_dict({k: full_tensor(v) for k, v in model.state_dict().items()})
        return plain

    def shard(t, dim=0):
        return t if strategy is None else strategy.shard_train(t, dim)

    def shard_eval(t, dim=0):
        return t if strategy is None else strategy.shard_eval(t, dim)

    def eps_of(b, gen, samples=n_samples):
        """Noise of one batch of b: [b, latent] for the set models,
        [samples, b, latent] for the FlexibleVAE family and LIDVAE."""
        return _noise((b, latent) if is_set else (samples, b, latent), gen, device)

    has_warmup = getattr(model, "has_warmup", False)
    wu_alpha, last_kl = 0.0, 0.0
    if has_warmup and start_epoch > 0:
        if "wu_alpha" in resume_extra:
            # the restored warmup state continues kl_adaptive exactly
            wu_alpha = float(resume_extra["wu_alpha"])
            last_kl = float(resume_extra.get("last_kl", 0.0))
        else:
            # a checkpoint without it: replay the deterministic schedules
            # (kl_adaptive degrades to alpha(kl=0)), as the JAX trainer does
            for e in range(start_epoch):
                wu_alpha = warmup_alpha(wu_alpha, e, epochs, wu_strat, last_kl_loss=last_kl)
    eval_means = {k: 0.0 for k in _METRICS}
    async_ckpt = ckpt_lib.AsyncCheckpointer() if async_checkpoint and checkpoint_every else None
    t_start = time.time()

    for epoch in range(start_epoch, epochs):
        if has_warmup:
            wu_alpha = warmup_alpha(wu_alpha, epoch, epochs, wu_strat, last_kl_loss=last_kl)
            explog.log_alpha_value(epoch, wu_alpha)

        ep_np_rng = np.random.default_rng([seed, epoch])
        noise = _generator(seed, epoch, _TRAIN)
        # each 'data' rank draws its own masks (JAX folds the rank into its key)
        drop_stream = ((_DROPOUT,) if mesh is None
                       else (_DROPOUT, data_coordinate(mesh, strategy.batch_axis)[0]))
        dropout_rng = _generator(seed, epoch, *drop_stream, device=device) if is_set else None
        augment_rng = _generator(seed, epoch, _AUGMENT) if augment is not None else None
        ms = []
        # epoch 0 holds the first calls; the metrics' fetch ends the trace
        with trace(profile_dir) if profile_dir is not None and epoch == 1 else nullcontext():
            for x, _y in iterate_batches(train_ds, batch_size, rng=ep_np_rng, device=device,
                                         augment=augment, augment_rng=augment_rng,
                                         native_prefetch=native_prefetch):
                eps = eps_of(x.shape[0], noise)
                ms.append(train_step(shard(x), shard(eps, eps.dim() - 2), wu_alpha,
                                     dropout_rng))
                state.step += 1
            train_means = _means(ms)
        writer.add_scalar("loss/train", train_means["loss"], epoch)
        writer.add_scalar("recon/train", train_means["recon"], epoch)
        writer.add_scalar("reg/train", train_means["reg"], epoch)
        # kl_adaptive warmup reads the LAST batch's unscaled KL (model.py:62, 614)
        last_kl = float(ms[-1]["raw_kl"]) if has_warmup else 0.0
        last_epoch = epoch == epochs - 1
        if strategy is not None and strategy.sync is not None:
            # pipeline parallelism: every layer from its stage to every rank
            # before the eval, and the Adam moments too where a checkpoint
            # follows or the run ends (JAX :905-916)
            state = strategy.sync(state, last_epoch or bool(
                checkpoint_every and (epoch + 1) % checkpoint_every == 0))

        noise = _generator(seed, epoch, _EVAL)
        ev_ms, last_eval_batch = [], None
        for x, y in iterate_batches(test_ds, batch_size, rng=ep_np_rng,
                                    shuffle=data_type == "1d", device=device):
            eps = eps_of(x.shape[0], noise, 1)
            ev_ms.append(eval_step(shard_eval(x), shard_eval(eps, eps.dim() - 2), wu_alpha))
            last_eval_batch = (x, y)
        eval_means = _means(ev_ms)
        writer.add_scalar("loss/test", eval_means["loss"], epoch)

        if progress and is_main and (epoch % max(1, epochs // 20) == 0 or last_epoch):
            print(
                f"[{name}] epoch {epoch}: train loss {train_means['loss']:.4f} "
                f"recon {train_means['recon']:.4f} reg {train_means['reg']:.4f} "
                f"| test loss {eval_means['loss']:.4f}",
                flush=True,
            )

        if checkpoint_every and (epoch + 1) % checkpoint_every == 0:
            ckpt_path = os.path.join(result_dir, "params", f"ckpt_{epoch}.pkl")
            ckpt_extra = {"wu_alpha": float(wu_alpha), "last_kl": float(last_kl)}
            if async_ckpt is not None:
                async_ckpt.submit(ckpt_path, state, epoch, extra=ckpt_extra)
            else:
                ckpt_lib.save_checkpoint(ckpt_path, state, epoch, extra=ckpt_extra)

        if last_epoch:
            ckpt_lib.save_params_only(
                os.path.join(result_dir, "params", f"model_{epoch}.pkl"), gather_plain())
        if last_epoch and visualize_artifacts:
            dump_noise = _generator(seed, epoch, _DUMP)
            if is_set:
                _dump_set_samples(plain, test_ds, decode_fn, forward_fn, resultname, name,
                                  epoch, output_root, dump_noise, device)
            elif last_eval_batch is not None:
                _dump_artifacts(plain, last_eval_batch, encode_fn, decode_fn, forward_fn,
                                data_type, resultname, name, epoch, output_root, dump_noise,
                                device)

    writer.close()
    gather_plain()

    fid = -1
    if epochs < 0:
        generated = _generate_images(model, decode_fn, batch_size, result_dir, name,
                                     _generator(seed, 0, _GENERATE), device)
        fid = _compute_fid(test_ds, generated, device)

    # final metrics on one 50-sample batch (main.py:363-372)
    noise = _generator(seed, max(epochs, 0), _FINAL)
    mb = min(50, len(test_ds))
    xb = torch.from_numpy(test_ds.X[:mb]).to(device)
    outs = forward_fn(xb, eps_of(mb, noise, 1))
    with torch.no_grad():
        _, loss_rec, _, _ = plain.loss(xb, *outs, wu_alpha=wu_alpha)
        pm = metrics_lib.measure_posterior_metrics(noise, outs[1], outs[2], loss_rec)
    pm = {k: float(v) for k, v in pm.items()}

    duration = time.time() - t_start
    explog.log_evaluation_metrics(
        au=pm["au"], kl=pm["kl"], mi=pm["mi"], nll=pm["nll"], mean_var=pm["mean_var"],
        vloss=eval_means["loss"], vlrec=eval_means["recon"],
        vlreg=eval_means["reg"], vllr=eval_means["lr"],
    )
    explog.log_alpha_warmup_summary(wu_strat)
    explog.finalize_log()
    loggers.log_unified_dict(
        os.path.join(output_root, "log"),
        {
            "name": name, "dataset_name": dataset_name, "epoch": epochs, "fid": fid,
            "au": pm["au"], "kl": pm["kl"], "mi": pm["mi"], "nll": pm["nll"],
            "vloss": eval_means["loss"], "vlrec": eval_means["recon"],
            "vlreg": eval_means["reg"], "vllr": eval_means["lr"],
            "mean_var": pm["mean_var"],
        },
        logfilename=logfilename,
    )
    if async_ckpt is not None:
        # join the writes in flight before handing the result dir back; a
        # failed write must not discard the trained state the caller is owed
        try:
            async_ckpt.close()
        except Exception as e:
            print(f"[{name}] WARNING: async checkpoint write failed: {e!r} "
                  "(training completed; the periodic snapshot is missing)",
                  file=sys.stderr, flush=True)

    summary = dict(name=name, duration_sec=duration, eval=eval_means,
                   posterior_metrics=pm, result_dir=result_dir, fid=fid)
    if not is_main:
        shutil.rmtree(output_root, ignore_errors=True)
    if owns_group:
        dist.destroy_process_group()
    return state, summary


def _dump_set_samples(model, test_ds, decode_fn, forward_fn, resultname, name, epoch, root,
                      noise, device, n_samples=4):
    """Point-cloud recon/prior .ply/.npy dumps (main.py:52-89): the first
    test clouds and their reconstructions from mu, then clouds decoded
    from z ~ N(0, I)."""
    outdir = os.path.join(root, "results", resultname, name, "point_clouds")
    os.makedirs(outdir, exist_ok=True)
    for i in range(min(n_samples, len(test_ds))):
        x = torch.from_numpy(test_ds.X[i:i + 1]).to(device)
        recon = forward_fn(x)[0]
        save_point_cloud(recon[0], os.path.join(outdir, f"{name}_epoch{epoch}_recon_{i:02d}"))
        save_point_cloud(test_ds.X[i], os.path.join(outdir, f"{name}_epoch{epoch}_orig_{i:02d}"))
    for i in range(n_samples):
        z = torch.randn(1, model.latent_channel, generator=noise).to(device)
        pts = decode_fn(z)
        save_point_cloud(pts[0], os.path.join(outdir, f"{name}_epoch{epoch}_prior_{i:02d}"))


def _dump_artifacts(model, last_batch, encode_fn, decode_fn, forward_fn, data_type,
                    resultname, name, epoch, root, noise, device):
    """The last-epoch plots of the last eval batch (main.py:110-170): for
    the 1-D datasets its points, mu, z and reconstruction (one latent
    sample each) and the decode of z ~ N(0, I), coloured by class, as
    `scatter2d/{epoch}_{input,mu,z,recon,sample}.png`; for images the grids
    `valontr/{epoch}_{origin,recon,recon_wos,sample}.png` (recon_wos decodes
    mu) of the first 256; then the PCA/t-SNE plots of mu and z under
    `pca/`. The noise is drawn from `noise` in that order: the forward's,
    the prior's, the PCA's. Non-image 2-D data gets only the PCA (JAX's
    image grid would fail on it)."""
    x, y = last_batch
    latent = model.latent_channel
    outs = forward_fn(x, _noise((1, x.shape[0], latent), noise, device))
    sample = decode_fn(_noise((x.shape[0], latent), noise, device))
    pca_eps = _noise((min(x.shape[0], 1000), latent), noise, "cpu")
    if data_type == "1d":
        z = outs[3].reshape(-1, latent)          # [1, B, latent] or LIDVAE's [B, latent]
        plots = {"input": x, "mu": outs[1], "z": z, "recon": outs[0], "sample": sample}
        try:
            for tensor_name, points in plots.items():
                visualize_2c_points_on_image(points, y, resultname, name, epoch, tensor_name,
                                             root)
        except ImportError as e:
            # visualization must never kill a training run (the JAX trainer's rule)
            print(f"[{name}] scatter2d plots {list(plots)} not written: {e!r}", flush=True)
    elif x.dim() == 4:
        outdir = os.path.join(root, "results", resultname, name, "valontr")
        grids = {"origin": x, "recon": outs[0].clamp(0, 1),
                 "recon_wos": forward_fn(x)[0].clamp(0, 1), "sample": sample.clamp(0, 1)}
        try:
            for tag, images in grids.items():
                save_image_grid(images[:256], os.path.join(outdir, f"{epoch}_{tag}.png"))
        except ImportError as e:
            print(f"[{name}] valontr grids {list(grids)} not written: {e!r}", flush=True)

    def enc(xx):
        return encode_fn(torch.from_numpy(np.ascontiguousarray(xx)).to(device))

    try:
        pca_visualization(enc, x, y, pca_eps, epoch, name, resultname, root=root)
    except Exception as e:  # visualization must never kill a training run
        print(f"[{name}] pca_visualization failed: {e!r}", flush=True)


def _generate_images(model, decode_fn, batch_size, result_dir, name, noise, device):
    """Generation-only mode: SAMPLE_ITERATION batches of z ~ N(0, I) from
    `noise`, decoded and clipped to [0, 1], one PNG an image at
    `generation/{index}.png`; returns them [N, H, W, C] as numpy. Without
    matplotlib the PNGs are skipped with one line."""
    gen_dir = os.path.join(result_dir, "generation")
    os.makedirs(gen_dir, exist_ok=True)
    out, write = [], True
    for i in range(SAMPLE_ITERATION):
        z = _noise((batch_size, model.latent_channel), noise, device)
        images = decode_fn(z).clamp(0, 1).float().cpu().numpy()
        out.append(images)
        for j in range(batch_size if write else 0):
            try:
                save_image_grid(images[j:j + 1], os.path.join(gen_dir, f"{i * batch_size + j}.png"),
                                nrow=1, normalize=True)
            except ImportError as e:
                print(f"[{name}] generation PNGs not written: {e!r}", flush=True)
                write = False
                break
    return np.concatenate(out)
