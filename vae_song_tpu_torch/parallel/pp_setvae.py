"""Pipeline parallelism for the attention SetVAE / SetLRVAE: the encoder's
transformer layers as GPipe stages (port of
vae_song_tpu/parallel/pp_setvae.py).

  * the `num_encoder_layers` layers are split into contiguous groups, one
    a stage of the 'stage' group; each stage trains only its own layers
    (the others stay on the rank, unused, until `pp_sync`);
  * the input projection runs on every stage, only the first stage's
    output enters the pipeline (parallel/pp.py:_pipeline);
  * the rest of the model (pool, latent heads, the whole decoder, the
    loss) runs redundantly on every stage from the pipeline's output,
    which every stage receives.

Gradient conventions (JAX docstring :20-31), exact:
  * the stage's own layers: complete on their stage, no collective;
  * the input projection: its cotangent reaches it through the first
    stage only, so its gradient is summed over the stages;
  * everything after the pipeline: the same on every stage, averaged.
SetLRVAE re-encodes the decoded cloud through a second pipeline pass,
behind `psum_cotangent` so that the decoder, which every stage computes,
sees the second pass's cotangent on every stage.

DP x PP: a ('data', 'stage') mesh (`make_dp_pp_mesh`), 'stage' innermost;
each data row pipelines its own batch shard and every gradient is then
averaged over 'data', as is the metrics. The clip, if configured, runs
after those reductions with the true global norm: the stage-local layers'
norms summed over the stages, the replicated ones counted once.

The step takes the noise as an input (`eps`; None decodes from mu), as
every step of the port does; every stage of a row uses the row's block.

`split_params` / `merge_params` lay a state_dict out as JAX's pipeline
tree ({"enc_stack": the layers stacked, "pre": the input projection,
"post": the rest}) and back, `split_opt_state` / `merge_opt_state` do the
same to `train.state.adam_state`'s tree; the trainer keeps the model
whole on every rank and `pp_sync` brings each layer (and, for a
checkpoint, its Adam moments) from its stage to every rank.
"""

import math

import torch
import torch.distributed as dist

from vae_song_tpu_torch.nn.collectives import psum_cotangent
from vae_song_tpu_torch.parallel import optree
from vae_song_tpu_torch.parallel.pp import STAGE_AXIS, _check_layers, _pipeline
from vae_song_tpu_torch.train.steps import _TERMS, _metrics

ENC_LAYER = "encoder.layers."
PRE = "encoder.embed."
DATA_AXIS = "data"


def make_dp_pp_mesh(n_data: int, n_stages: int):
    """The ('data', 'stage') DeviceMesh of n_data x n_stages ranks, 'stage'
    innermost (JAX :72)."""
    from torch.distributed.device_mesh import init_device_mesh

    from vae_song_tpu_torch.parallel.mesh import device_type

    n = n_data * n_stages
    if dist.get_world_size() < n:
        raise ValueError(f"need {n} devices for a {n_data}x{n_stages} "
                         f"data x stage mesh; have {dist.get_world_size()}")
    return init_device_mesh(device_type(), (n_data, n_stages),
                            mesh_dim_names=(DATA_AXIS, STAGE_AXIS))


def _layer_index(name: str):
    """(layer index, the name inside the layer) of an encoder layer's
    entry, else None."""
    if not name.startswith(ENC_LAYER):
        return None
    i, rest = name[len(ENC_LAYER):].split(".", 1)
    return int(i), rest


def split_params(params: dict, n_layers: int) -> dict:
    """A state_dict-keyed tree -> {"enc_stack": {name in the layer: the
    n_layers layers' tensors stacked [L, ...]}, "pre": the input
    projection's entries, "post": every other entry} (JAX :90)."""
    layers = [{} for _ in range(n_layers)]
    pre, post = {}, {}
    for name, t in params.items():
        where = _layer_index(name)
        if where is not None:
            layers[where[0]][where[1]] = t
        elif name.startswith(PRE):
            pre[name] = t
        else:
            post[name] = t
    stack = {k: torch.stack([layer[k] for layer in layers]) for k in layers[0]}
    return {"enc_stack": stack, "pre": pre, "post": post}


def merge_params(pp_params: dict, n_layers: int) -> dict:
    """Inverse of split_params: the state_dict-keyed tree."""
    out = dict(pp_params["pre"])
    for k, v in pp_params["enc_stack"].items():
        for i in range(n_layers):
            out[f"{ENC_LAYER}{i}.{k}"] = v[i]
    out.update(pp_params["post"])
    return out


def split_opt_state(opt_state: dict, n_layers: int) -> dict:
    """`adam_state`'s {"count", "mu", "nu"} with the moments split as
    split_params splits the parameters (JAX :129)."""
    return {"count": opt_state["count"], "mu": split_params(opt_state["mu"], n_layers),
            "nu": split_params(opt_state["nu"], n_layers)}


def merge_opt_state(opt_state: dict, n_layers: int) -> dict:
    """Inverse of split_opt_state (JAX :141)."""
    return {"count": opt_state["count"], "mu": merge_params(opt_state["mu"], n_layers),
            "nu": merge_params(opt_state["nu"], n_layers)}


def pp_param_specs(pp_params: dict) -> dict:
    """The placement of each entry of a split tree (JAX :107): the stacked
    layers on 'stage', the rest replicated."""
    return {"enc_stack": {k: (STAGE_AXIS,) for k in pp_params["enc_stack"]},
            "pre": {k: () for k in pp_params["pre"]},
            "post": {k: () for k in pp_params["post"]}}


def stage_layers(mesh, n_layers: int) -> range:
    """The indices of the encoder layers this rank's stage runs."""
    group = mesh.get_group(STAGE_AXIS)
    s, n = dist.get_rank(group), dist.get_world_size(group)
    _check_layers(n_layers, n)
    per = n_layers // n
    return range(s * per, (s + 1) * per)


def shard_pp_setvae_state(state, mesh):
    """The first rank's parameters and Adam moments on every rank of the
    mesh (mesh.replicate_state), from which each stage trains its layers
    (JAX :158 places the stacked layers on their stages)."""
    from vae_song_tpu_torch.parallel.mesh import replicate_state

    return replicate_state(state, mesh)


@torch.no_grad()
def pp_sync(state, mesh, with_opt: bool = False):
    """Every encoder layer's parameters (and, with `with_opt`, its Adam
    moments) broadcast from its stage to the other stages of the row,
    so each rank holds the trained model whole for the eval, the
    checkpoint and the exports (JAX loop.py:414-436)."""
    model = state.model
    group = mesh.get_group(STAGE_AXIS)
    n = dist.get_world_size(group)
    layers = model.encoder.layers
    per = len(layers) // n
    adam = state.optimizer.adam
    slot = {id(p): i for i, p in enumerate(state.optimizer.params)}
    for i, layer in enumerate(layers):
        src = dist.get_global_rank(group, i // per)
        for p in layer.parameters():
            tensors = [p.data]
            if with_opt and id(p) in slot:
                tensors += [adam.mu[slot[id(p)]], adam.nu[slot[id(p)]]]
            for t in tensors:
                dist.broadcast(t, src, group=group)
    return state


def _pnorm_part(grads, p: float):
    flat = [g.float().reshape(-1).abs() for g in grads]
    if not flat:
        return None
    if p == math.inf:
        return torch.stack([g.max() for g in flat]).max()
    return sum((g ** p).sum() for g in flat)


def _stage_pnorm(local, replicated, p: float, group):
    """The global p-norm of the stage-local gradients (a slice a stage)
    and the replicated ones (counted once)."""
    ref = (local or replicated)[0]
    part = _pnorm_part(local, p)
    part = ref.new_zeros((), dtype=torch.float32) if part is None else part
    dist.all_reduce(part, op=dist.ReduceOp.MAX if p == math.inf else dist.ReduceOp.SUM,
                    group=group)
    rest = _pnorm_part(replicated, p)
    if rest is not None:
        part = torch.maximum(part, rest) if p == math.inf else part + rest
    return part if p == math.inf else part ** (1.0 / p)


def _check_pp_model(model):
    from vae_song_tpu_torch.models.setvae import SetEncoderAttn, SetLRVAE, SetVAE

    if not (isinstance(model, SetVAE) and isinstance(model.encoder, SetEncoderAttn)):
        raise ValueError(
            "pipeline parallelism drives the attention SetVAE/SetLRVAE "
            f"encoder stack; got {type(model).__name__} use_attention="
            f"{isinstance(getattr(model, 'encoder', None), SetEncoderAttn)}"
        )
    dropout = model.encoder.layers[0].drop.rate
    if dropout:
        raise NotImplementedError(
            f"attn_dropout={dropout} is not supported under "
            "pipeline parallelism (the PP step rebuilds the layers with "
            "dropout_rate=0.0); set attn_dropout: 0 or drop "
            "pipeline_parallel"
        )
    if getattr(model, "moe_experts", 0):
        raise NotImplementedError(
            f"moe_experts={model.moe_experts} is not supported under "
            "pipeline parallelism (MoE FFNs train under expert_parallel); "
            "set moe_experts: 0 or drop pipeline_parallel"
        )
    return isinstance(model, SetLRVAE)


def default_n_micro(batch: int, n_stages: int) -> int:
    """The trainer's microbatch count for a pipeline's batch of `batch`
    over `n_stages` stages: GPipe wants n_micro >= n_stages for a small
    bubble, so the first count from n_stages to 4 n_stages that divides
    the batch, else 1 (JAX train/loop.py:382-390)."""
    return next((m for m in range(n_stages, 4 * n_stages + 1) if batch % m == 0), 1)


def make_setvae_pp_train_step(model, optimizer, mesh, n_micro: int,
                              grad_clip: dict | None = None):
    """Pipelined SetVAE / SetLRVAE train step over the mesh's 'stage'
    group (JAX :167): step(x, eps, wu_alpha) -> the metrics, x this
    row's batch [B, N, 3] (B % n_micro == 0; the whole batch without a
    'data' dimension, mesh.shard_batch's slice with one), eps its noise
    or None (z = mu); num_encoder_layers must divide over the stages.
    The model is the whole model on every rank, its state from
    `shard_pp_setvae_state`; `remat` recomputes each layer in the
    backward, as on one device (JAX :249-254). The clip of `grad_clip`
    (default: the optimizer's) runs in the step after the reductions;
    the optimizer's own is switched off."""
    is_lr = _check_pp_model(model)
    group = mesh.get_group(STAGE_AXIS)
    n_stages = dist.get_world_size(group)
    has_dp = DATA_AXIS in mesh.mesh_dim_names
    data = mesh.get_group(DATA_AXIS) if has_dp else None
    n_data = dist.get_world_size(data) if has_dp else 1
    enc = model.encoder
    local = stage_layers(mesh, len(enc.layers))
    clip_cfg = optimizer.grad_clip if grad_clip is None else grad_clip
    optimizer.clip = None
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for p in optimizer.params if p.requires_grad]
    act_dtype = enc.layers[0].norm2.dtype

    def stage_fn(h):
        from vae_song_tpu_torch.models.setvae import _checkpointed

        for i in local:
            layer = enc.layers[i]
            h = _checkpointed(layer, h, None) if enc.remat else layer(h)
        return h

    def encode(pts):
        h = enc.embed(pts)
        if h.shape[0] % n_micro:
            raise ValueError(f"a batch of {h.shape[0]} does not divide into {n_micro} "
                             "microbatches")
        y = _pipeline(stage_fn, h.split(h.shape[0] // n_micro), group, act_dtype)
        s = y.amax(dim=1)
        return enc.fc_mu(s), enc.fc_logvar(s)

    def kind(p):
        where = _layer_index(names[id(p)])
        if where is not None:
            return "stage" if where[0] in local else None
        return "pre" if names[id(p)].startswith(PRE) else "post"

    kinds = {id(p): kind(p) for p in params}

    @torch.no_grad()
    def reduce():
        """Stage-local layers as they are, the input projection summed and
        the rest averaged over the stages, then all averaged over 'data'."""
        live = [p for p in params if p.grad is not None and kinds[id(p)] is not None]
        pre = [p.grad for p in live if kinds[id(p)] == "pre"]
        post = [p.grad for p in live if kinds[id(p)] == "post"]
        if pre:
            optree._coalesced_mean(pre, group, 1)
        optree._coalesced_mean(post, group, n_stages)
        if has_dp:
            optree._coalesced_mean([p.grad for p in live], data, n_data)
        local_grads = [p.grad for p in live if kinds[id(p)] == "stage"]
        others = [p.grad for p in live if kinds[id(p)] != "stage"]
        k = len(local_grads)
        clip = optree.make_shardmap_clip(
            clip_cfg, norm_fn=lambda gs, p: _stage_pnorm(gs[:k], gs[k:], p, group))
        if clip is not None:
            clip(local_grads + others)

    def step(x, eps, wu_alpha=0.0):
        model.train()
        optimizer.zero_grad()
        mu, log_var = encode(x)
        z = mu if eps is None else mu + eps * torch.exp(0.5 * log_var)
        if is_lr:
            # decode from the detached z; the second pipeline pass's
            # cotangent reaches the decoder on every stage (psum_cotangent)
            recon = model.decoder(z.detach())
            z_recon, _ = encode(psum_cotangent(recon, group))
        else:
            recon, z_recon = model.decoder(z), None
        terms = model.loss(x, recon, mu, log_var, z, z_recon, wu_alpha=wu_alpha)
        terms[0].backward()
        m = _metrics(model, terms, (recon, mu, log_var, z, z_recon))
        reduce()
        if has_dp:
            optree._coalesced_mean([m], data, n_data)
        optimizer.step()
        return dict(zip(_TERMS, m.unbind()))

    return step
