"""SetVAE / SetLRVAE for 3-D point clouds (port of
vae_song_tpu/models/setvae.py): the transformer encoder and decoder
(`use_attention: true`, :80-225 and :265-406) and the DeepSets MLP
encoder and decoder with BatchNorm (`use_attention: false`, :227-247
and :303-327), for evaluation and training.

The transformer layers follow torch's nn.TransformerEncoderLayer /
nn.TransformerDecoderLayer defaults as the JAX package does: post-norm
residuals, ReLU feed-forward, batch-first, and in training dropout at
the torch positions (attn_dropout; 0.0 in every shipped config): on the
attention weights (ops/attention.py), on the attention output, on the
FFN's hidden activation after the ReLU and on the FFN output; the
decoder layer applies its one shared dropout after the cross-attention
too. Eval mode is dropout-free. The keep masks come from an explicit
source (`dropout_rng`: a torch.Generator, or a callable that hands out
masks; nn.blocks.keep_mask), drawn in the JAX package's call order.

Under `mixed_precision` the dtypes flow as in the JAX package: the
attention projections, the FFN and the LayerNorm outputs are bf16; the
encoder's input embedding, the latent heads, the decoder's memory
projection and the final Dense(3) promote to f32, so recon, mu and
logvar are f32 and the Chamfer loss runs in f32. The first residual add
of the encoder is f32 + bf16 = f32. The DeepSets models run in f32
whatever `mixed_precision` says, as the JAX package passes them no dtype.

The FFN follows the JAX package's opt-in switch `VST_FUSED_FFN=1`
(models/setvae.py:32-77), read at every call as the JAX package reads it
at every trace: for a dropout-free call on `fused_ffn_ok` shapes, the
residual FFN `x + ff_down(relu(ff_up(x)))` runs as one fused op
(ops/ffn.py, the K6f / K6b kernels on CUDA tensors, their plain versions
on CPU tensors) on the same `ff_up` / `ff_down` parameters, then the
LayerNorm. The switch does not depend on the device. Off (the default),
the two Dense layers run. With `moe_experts: E` (JAX :113-120, :182-207)
every transformer layer's FFN is a top-1 mixture of E experts instead
(nn/moe.py), followed by the dropout; the fused FFN never applies then.

`remat` (JAX :267-277, :349, :373-391) wraps each transformer layer in
`torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`: the
backward recomputes the layer's activations instead of keeping them, so
the attention kernels' forward runs again there. The recompute draws the
same dropout masks as the first pass (`_checkpointed`). Under remat the
decoder's first layer forgoes the batch-constant self-attention shortcut,
as JAX does.

Inside nn.sync.sequence_sharded (sequence parallelism, parallel/sp.py;
the JAX package's `seq_axis` clone, :90-104, :158-171) the clouds and
activations hold this rank's slice of the points: the layers'
self-attentions gather keys and values from the group (or take the
ring), the encoder's max-pool gathers the [B, d_model] pooled vectors of
every shard and takes their max (JAX :293-299), the decoder decodes this
rank's contiguous slice of `query_embed` (:362-367), and the Chamfer
loss is `chamfer_sp`'s per-shard value (:542-550). Inside
nn.sync.expert_sharded the MoE FFNs run expert-parallel (nn/moe.py).
Neither context changes a parameter or its name.

Randomness is explicit: `forward(x, eps, dropout_rng)` takes the
reparameterisation noise and the dropout mask source, and `decode(z)`
the latent.

Gradients follow the JAX package: SetLRVAE decodes from `z.detach()`
(its `stop_gradient`); without dropout the decoder's first
self-attention, run once at batch 1 and broadcast with `expand`,
receives the cotangent summed over the batch, so its backward runs at
B = 1 too (with attn_dropout > 0 that layer runs at full batch, as in
JAX, whose masks differ per cloud). The DeepSets BatchNorm layers move
their running statistics at every train-mode call, so SetLRVAE's
re-encode moves the encoder's twice a step: encode(x), then
encode(recon), as Flax's mutable `batch_stats` does.
"""

import os

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from vae_song_tpu_torch.nn import collectives
from vae_song_tpu_torch.nn.blocks import BatchNorm, Dense, Dropout, LayerNorm
from vae_song_tpu_torch.nn.sync import full_tensor, seq_shard
from vae_song_tpu_torch.nn.initializers import normal_scaled_
from vae_song_tpu_torch.nn.moe import MoEFFN
from vae_song_tpu_torch.ops import losses
from vae_song_tpu_torch.ops.attention import MultiHeadAttention
from vae_song_tpu_torch.ops.chamfer import best_chamfer, chamfer_sp
from vae_song_tpu_torch.ops.ffn import fused_ffn, fused_ffn_ok


def _ffn_fused_on() -> bool:
    """The opt-in switch VST_FUSED_FFN=1 (or true), off by default."""
    return os.environ.get("VST_FUSED_FFN", "0").lower() in ("1", "true")


def _use_fused_ffn(x, ff_dim: int, dropout_rate: float, training: bool) -> bool:
    """Route this FFN through `fused_ffn`? The switch on, a dropout-free
    call (dropout acts on the hidden activation, which the fused op never
    materialises) and kernel-eligible shapes, as the JAX gate has it."""
    if dropout_rate > 0.0 and training:
        return False
    if not _ffn_fused_on():
        return False
    m = 1
    for s in x.shape[:-1]:
        m *= s
    return fused_ffn_ok(m, x.shape[-1], ff_dim)


def _residual_ffn(layer, x, dropout_rng):
    """x + drop(moe_ffn(x)) with experts, else x +
    drop(ff_down(drop(relu(ff_up(x))))), fused when `_use_fused_ffn` says
    so (the residual added inside, the parameters cast to the compute
    dtype as Dense casts them)."""
    drop = layer.drop
    if layer.moe_ffn is not None:
        return x + drop(layer.moe_ffn(x), dropout_rng)
    ff_up, ff_down = layer.ff_up, layer.ff_down
    if _use_fused_ffn(x, ff_up.weight.shape[0], drop.rate, drop.training):
        cd = ff_up.dtype or x.dtype
        # under tensor parallelism every rank runs the whole FFN on the
        # gathered weights, as GSPMD runs the JAX kernel, which has no
        # partition rule; the weights' backward keeps each rank's slice
        w = [full_tensor(t).to(cd) for t in (ff_up.weight, ff_up.bias,
                                             ff_down.weight, ff_down.bias)]
        return fused_ffn(x.to(cd), *w)
    ff = drop(torch.relu(ff_up(x)), dropout_rng)
    return x + drop(ff_down(ff), dropout_rng)


def _ffn(layer, d_model, ff_dim, moe_experts, moe_capacity_factor, cd, generator):
    """The layer's FFN parameters: `moe_ffn` with experts, else `ff_up`
    and `ff_down`."""
    if moe_experts > 0:
        layer.moe_ffn = MoEFFN(d_model, ff_dim, moe_experts, moe_capacity_factor, cd, generator)
    else:
        layer.moe_ffn = None
        layer.ff_up = Dense(d_model, ff_dim, dtype=cd, generator=generator)
        layer.ff_down = Dense(ff_dim, d_model, dtype=cd, generator=generator)


def _checkpointed(fn, x, dropout_rng, *args):
    """fn(x, *args, dropout_rng) under torch.utils.checkpoint (non-
    reentrant), its recompute in the backward drawing the masks of the
    first pass: a torch.Generator is set back to its state before the
    first pass for the recompute and restored after it (checkpoint's
    preserve_rng_state covers only the default generators); a callable
    source's masks are recorded and handed out again."""
    if dropout_rng is None:
        return checkpoint(fn, x, *args, None, use_reentrant=False)
    passes = []
    if isinstance(dropout_rng, torch.Generator):
        start = dropout_rng.get_state()

        def run(x, *args):
            if not passes:
                passes.append(True)
                return fn(x, *args, dropout_rng)
            now = dropout_rng.get_state()
            dropout_rng.set_state(start)
            try:
                return fn(x, *args, dropout_rng)
            finally:
                dropout_rng.set_state(now)
    else:
        masks = []

        def record(shape, keep_prob):
            masks.append(dropout_rng(shape, keep_prob))
            return masks[-1]

        def run(x, *args):
            if not passes:
                passes.append(True)
                return fn(x, *args, record)
            replay = iter(masks)
            return fn(x, *args, lambda shape, keep_prob: next(replay))
    return checkpoint(run, x, *args, use_reentrant=False)


class TransformerEncoderLayer(nn.Module):
    """Post-norm self-attention + ReLU FFN."""

    def __init__(self, d_model, num_heads, ff_dim, dropout_rate=0.0,
                 compute_dtype=None, generator=None, moe_experts=0, moe_capacity_factor=1.25):
        super().__init__()
        cd = compute_dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, cd, generator,
                                            self_attention=True)
        self.norm1 = LayerNorm(d_model, cd)
        _ffn(self, d_model, ff_dim, moe_experts, moe_capacity_factor, cd, generator)
        self.norm2 = LayerNorm(d_model, cd)
        self.drop = Dropout(dropout_rate)

    def forward(self, x, dropout_rng=None):
        attn = self.drop(self.self_attn(x, x, dropout_rng), dropout_rng)
        x = self.norm1(x + attn)
        return self.norm2(_residual_ffn(self, x, dropout_rng))


class TransformerDecoderLayer(nn.Module):
    """Post-norm self-attention, cross-attention to the memory, ReLU FFN.
    Split in two halves so the set decoder can run its first layer's
    self-attention once on the batch-constant queries."""

    def __init__(self, d_model, num_heads, ff_dim, dropout_rate=0.0,
                 compute_dtype=None, generator=None, moe_experts=0, moe_capacity_factor=1.25):
        super().__init__()
        cd = compute_dtype
        self.self_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, cd, generator,
                                            self_attention=True)
        self.norm1 = LayerNorm(d_model, cd)
        self.cross_attn = MultiHeadAttention(d_model, num_heads, dropout_rate, cd, generator)
        self.norm2 = LayerNorm(d_model, cd)
        _ffn(self, d_model, ff_dim, moe_experts, moe_capacity_factor, cd, generator)
        self.norm3 = LayerNorm(d_model, cd)
        self.drop = Dropout(dropout_rate)

    def self_attn_block(self, tgt, dropout_rng=None):
        sa = self.drop(self.self_attn(tgt, tgt, dropout_rng), dropout_rng)
        return self.norm1(tgt + sa)

    def cross_ffn_block(self, tgt, memory, dropout_rng=None):
        ca = self.drop(self.cross_attn(tgt, memory, dropout_rng), dropout_rng)
        tgt = self.norm2(tgt + ca)
        return self.norm3(_residual_ffn(self, tgt, dropout_rng))

    def forward(self, tgt, memory, dropout_rng=None):
        return self.cross_ffn_block(self.self_attn_block(tgt, dropout_rng), memory, dropout_rng)


class SetEncoderAttn(nn.Module):
    """Transformer set encoder + max-pool over points -> (mu, logvar)."""

    def __init__(self, latent_dim=128, d_model=256, num_heads=4, num_layers=2,
                 ff_dim=512, dropout_rate=0.0, compute_dtype=None, generator=None,
                 moe_experts=0, moe_capacity_factor=1.25, remat=False):
        super().__init__()
        self.embed = Dense(3, d_model, generator=generator)
        self.layers = nn.ModuleList(
            TransformerEncoderLayer(d_model, num_heads, ff_dim, dropout_rate,
                                    compute_dtype, generator, moe_experts, moe_capacity_factor)
            for _ in range(num_layers)
        )
        self.fc_mu = Dense(d_model, latent_dim, generator=generator)
        self.fc_logvar = Dense(d_model, latent_dim, generator=generator)
        self.remat = remat

    def forward(self, points, dropout_rng=None):
        x = self.embed(points)
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                x = _checkpointed(layer, x, dropout_rng)
            else:
                x = layer(x, dropout_rng)
        s = x.amax(dim=1)
        sp = seq_shard()
        if sp is not None:
            # the points are sharded: the pool spans every shard, through
            # the gather's gradient (JAX :293-299; amax splits a tie's
            # gradient evenly, as JAX's max does)
            s = collectives.all_gather(s, sp.group, stack=True).amax(dim=0)
        return self.fc_mu(s), self.fc_logvar(s)


class SetDecoderAttn(nn.Module):
    """Learned per-point queries cross-attending to one latent memory
    token. Without dropout the first layer's self-attention sees only the
    batch-constant query embeddings, so it runs once at batch 1 and is
    broadcast (JAX :391 takes that shortcut only at dropout_rate 0 and
    without remat)."""

    def __init__(self, latent_dim=128, num_points=2048, d_model=256, num_heads=4,
                 num_layers=2, ff_dim=512, dropout_rate=0.0, compute_dtype=None,
                 generator=None, moe_experts=0, moe_capacity_factor=1.25, remat=False):
        super().__init__()
        self.query_embed = nn.Parameter(
            normal_scaled_(torch.empty(num_points, d_model), 0.02, generator)
        )
        self.memory = Dense(latent_dim, d_model, generator=generator)
        self.layers = nn.ModuleList(
            TransformerDecoderLayer(d_model, num_heads, ff_dim, dropout_rate,
                                    compute_dtype, generator, moe_experts, moe_capacity_factor)
            for _ in range(num_layers)
        )
        self.out = Dense(d_model, 3, generator=generator)
        self.dropout_rate = dropout_rate
        self.remat = remat

    def forward(self, z, dropout_rng=None):
        b = z.shape[0]
        memory = self.memory(z)[:, None, :]          # [B, 1, d_model]
        queries = self.query_embed
        n, d = queries.shape
        sp = seq_shard()
        if sp is not None:
            # this shard decodes its contiguous slice of the queries (JAX :362-367)
            n //= sp.size
            queries = queries.narrow(0, sp.index * n, n)
        x = queries[None]                            # [1, N, d_model]
        for i, layer in enumerate(self.layers):
            if i == 0 and self.dropout_rate == 0.0 and not self.remat:
                x = layer.self_attn_block(x).expand(b, n, d)
                x = layer.cross_ffn_block(x, memory)
            elif self.remat and torch.is_grad_enabled():
                x = _checkpointed(layer, x.expand(b, n, d), dropout_rng, memory)
            else:
                x = layer(x.expand(b, n, d), memory, dropout_rng)
        return self.out(x)


class SetEncoder(nn.Module):
    """DeepSets encoder: per-point Dense -> BatchNorm -> ReLU over
    `hidden_dims`, max / mean / sum pooling over the points, two Dense
    latent heads (JAX :227-247). `dense` holds the hidden layers, then
    the mu and logvar heads."""

    def __init__(self, hidden_dims=(128, 256, 512), latent_dim=128, pool_type="max",
                 generator=None):
        super().__init__()
        dims = (3, *hidden_dims)
        self.dense = nn.ModuleList(
            [Dense(i, o, generator=generator) for i, o in zip(dims, dims[1:])]
            + [Dense(dims[-1], latent_dim, generator=generator) for _ in range(2)]
        )
        self.norm = nn.ModuleList(BatchNorm(h) for h in hidden_dims)
        self.pool_type = pool_type

    def forward(self, points, dropout_rng=None):
        x = points
        for dense, norm in zip(self.dense, self.norm):
            x = torch.relu(norm(dense(x)))
        if self.pool_type == "mean":
            s = x.mean(dim=1)
        elif self.pool_type == "sum":
            s = x.sum(dim=1)
        else:
            s = x.amax(dim=1)
        return self.dense[-2](s), self.dense[-1](s)


class SetDecoder(nn.Module):
    """DeepSets decoder: learned per-point queries [N, 64] (N(0, 1) *
    0.02), the latent broadcast and concatenated before them, Dense ->
    BatchNorm -> ReLU over `hidden_dims`, Dense(3) (JAX :303-327).
    `dense` holds the hidden layers, then the output layer."""

    def __init__(self, latent_dim=128, num_points=2048, hidden_dims=(512, 256, 128),
                 generator=None):
        super().__init__()
        self.point_queries = nn.Parameter(
            normal_scaled_(torch.empty(num_points, 64), 0.02, generator)
        )
        dims = (latent_dim + 64, *hidden_dims)
        self.dense = nn.ModuleList(
            [Dense(i, o, generator=generator) for i, o in zip(dims, dims[1:])]
            + [Dense(dims[-1], 3, generator=generator)]
        )
        self.norm = nn.ModuleList(BatchNorm(h) for h in hidden_dims)

    def forward(self, z, dropout_rng=None):
        b = z.shape[0]
        n, q = self.point_queries.shape
        x = torch.cat([z[:, None, :].expand(b, n, z.shape[-1]),
                       self.point_queries[None].expand(b, n, q)], dim=-1)
        for dense, norm in zip(self.dense, self.norm):
            x = torch.relu(norm(dense(x)))
        return self.dense[-1](x)


class SetVAE(nn.Module):
    """Point-cloud VAE: Chamfer + beta * KL."""

    data_type = "set"

    def __init__(self, latent_channel=128, num_points=2048, encoder_hidden=(128, 256, 512),
                 decoder_hidden=(512, 256, 128), beta=1.0, pool_type="max", use_attention=True,
                 d_model=256, num_heads=4, num_encoder_layers=2, num_decoder_layers=2,
                 ff_dim=512, attn_dropout=0.0, mixed_precision=False, moe_experts=0,
                 moe_capacity_factor=1.25, remat=False, generator=None):
        super().__init__()
        self.latent_channel = latent_channel
        self.num_points = num_points
        self.beta = beta
        self.moe_experts = moe_experts
        self.moe_capacity_factor = moe_capacity_factor
        if moe_experts > 0 and not use_attention:
            raise NotImplementedError(
                "moe_experts applies to the attention set models' transformer FFNs "
                "(use_attention=True)")
        if use_attention:
            cd = torch.bfloat16 if mixed_precision else None
            moe = dict(moe_experts=moe_experts, moe_capacity_factor=moe_capacity_factor,
                       remat=remat)
            self.encoder = SetEncoderAttn(latent_channel, d_model, num_heads,
                                          num_encoder_layers, ff_dim, attn_dropout, cd,
                                          generator, **moe)
            self.decoder = SetDecoderAttn(latent_channel, num_points, d_model, num_heads,
                                          num_decoder_layers, ff_dim, attn_dropout, cd,
                                          generator, **moe)
        else:
            self.encoder = SetEncoder(encoder_hidden, latent_channel, pool_type, generator)
            self.decoder = SetDecoder(latent_channel, num_points, decoder_hidden, generator)

    def encode(self, x, dropout_rng=None):
        return self.encoder(x, dropout_rng)

    def decode(self, z, dropout_rng=None):
        return self.decoder(z, dropout_rng)

    @staticmethod
    def _sample(mu, log_var, eps):
        """z = mu + eps * exp(logvar / 2); z = mu when eps is None."""
        return mu if eps is None else mu + eps * torch.exp(0.5 * log_var)

    def forward(self, x, eps=None, dropout_rng=None):
        """Returns (recon, mu, logvar, z, z_recon=None)."""
        mu, log_var = self.encode(x, dropout_rng)
        z = self._sample(mu, log_var, eps)
        return self.decode(z, dropout_rng), mu, log_var, z, None

    @staticmethod
    def _chamfer(recon, x):
        """The per-shard Chamfer value under sequence parallelism (JAX
        :542-550), else `best_chamfer`."""
        sp = seq_shard()
        return best_chamfer(recon, x) if sp is None else chamfer_sp(recon, x, sp.group)

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        """(total, recon, reg, lr) with reg the unscaled KL."""
        loss_recon = self._chamfer(recon, x)
        loss_reg = losses.kl_divergence(mu, log_var)
        total = loss_recon + self.beta * loss_reg
        return total, loss_recon, loss_reg, torch.zeros((), device=x.device)


class SetLRVAE(SetVAE):
    """SetVAE + latent reconstruction: decode from a detached z, re-encode,
    add alpha * warmup * MSE(z, z_hat)."""

    # the trainer runs the kl_adaptive warmup of wu_alpha for this model
    has_warmup = True

    def __init__(self, alpha=0.01, **kwargs):
        super().__init__(**kwargs)
        self.alpha = alpha

    def forward(self, x, eps=None, dropout_rng=None):
        mu, log_var = self.encode(x, dropout_rng)
        z = self._sample(mu, log_var, eps)
        recon = self.decode(z.detach(), dropout_rng)
        z_recon, _ = self.encode(recon, dropout_rng)
        return recon, mu, log_var, z, z_recon

    def loss(self, x, recon, mu, log_var, z_input=None, z_recon=None, wu_alpha: float = 0.0):
        """(total, recon, beta * KL, alpha * warmup * latent-recon)."""
        loss_recon = self._chamfer(recon, x)
        loss_reg = losses.kl_divergence(mu, log_var)
        loss_lr = losses.latent_recon_loss(z_input, z_recon)
        total = loss_recon + self.beta * loss_reg + self.alpha * wu_alpha * loss_lr
        return total, loss_recon, self.beta * loss_reg, self.alpha * wu_alpha * loss_lr
