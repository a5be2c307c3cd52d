"""A/B of the MoE SetVAE train step's routing and dispatch on one CUDA
card (chip_smoke.py phase 12's step: the shipped SetVAE config with
`moe_experts: 4`, B = 64, N = 2048, bf16):

    python scripts/ab_moe_step.py

Three arms of `parallel/ep.py:moe_ffn_dense`, alternating in one
process (committed, gather, first, first, gather, committed):

  * committed: the queue count scanned along [E, T]'s contiguous axis,
    the tokens scattered into their slots (`index_copy`);
  * gather: that count, the tokens gathered from a zero-padded copy of x
    (the backward sums bf16 atomics onto the padding row);
  * first: the count as a scan down [T, E] (CUDA's outer-dimension scan
    kernel), and the gather.

Each arm prints chip_smoke's `_surface_steps` line (median and spread of
5 steps after 2 warm-ups, host clock); then torch.profiler's eight
largest CUDA ops over 2 steps of the committed and the first arm. The
first line is the card's name and power limit (nvidia-smi).
"""

import contextlib
import io
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from vae_song_tpu_torch.nn import moe  # noqa: E402
from vae_song_tpu_torch.parallel import ep  # noqa: E402


def _outer_scan_routing(x, router, n_experts, capacity):
    """The first version's routing: the queue count scanned down [T, E]."""
    probs = ep._softmax(x @ router)
    expert = probs.argmax(dim=-1)
    gate = probs.gather(1, expert[:, None])[:, 0]
    onehot = torch.nn.functional.one_hot(expert, n_experts)
    pos = (onehot.cumsum(dim=0) * onehot).sum(dim=-1) - 1
    return gate, expert * capacity + pos, pos < capacity


def _gather_moe(routing):
    def moe_ffn(params, x, capacity_factor=1.25):
        t, d = x.shape
        e = params.router.shape[1]
        c = ep._capacity(t, e, capacity_factor)
        gate, slot, keep = routing(x, params.router, e, c)
        empty = e * c
        slot = torch.where(keep, slot, empty)
        token = torch.full((empty + 1,), t, dtype=torch.long, device=x.device)
        token[slot] = torch.arange(t, device=x.device)
        x_pad = torch.cat([x, x.new_zeros(1, d)])
        expert_in = x_pad.index_select(0, token[:empty]).view(e, c, d)
        out = ep._expert_ffn(params.w1, params.b1, params.w2, params.b2, expert_in)
        out_pad = torch.cat([out.reshape(empty, d), out.new_zeros(1, d)])
        return gate[:, None] * out_pad.index_select(0, slot)

    return moe_ffn


ARMS = {"committed": ep.moe_ffn_dense, "gather": _gather_moe(ep._dispatch_combine),
        "first": _gather_moe(_outer_scan_routing)}


def main():
    smoke.phase_environment()
    with contextlib.redirect_stdout(io.StringIO()):
        smoke.phase_build()
    dev = torch.device("cuda", 0)
    params = dict(smoke.MODEL_PARAMS, **smoke.MOE_OVERRIDE)
    for name in ("committed", "gather", "first", "first", "gather", "committed"):
        moe.moe_ffn_dense = ARMS[name]
        smoke._surface_steps(params, dev, f"bf16 moe_experts 4 ({name})")
    for name in ("committed", "first"):
        moe.moe_ffn_dense = ARMS[name]
        model = smoke._build("setvae", params).to(dev)
        step = smoke.make_train_step(model, smoke.make_optimizer(model.parameters(), lr=smoke.LR))
        xs, eps = smoke._clouds_and_noise(4, smoke.BATCH, params, dev, smoke.SEED + 1)
        for i in range(2):
            float(step(xs[i], eps[i], 0.5)["loss"])
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for i in range(2, 4):
                float(step(xs[i], eps[i], 0.5)["loss"])
        print(f"--- {name}: the eight largest CUDA ops over 2 steps")
        for e in sorted(prof.key_averages(), key=lambda e: -e.device_time_total)[:8]:
            print(f"  {e.device_time_total / 1e3:9.3f} ms  {e.count:5d} calls  {e.key[:90]}")
    moe.moe_ffn_dense = ep.moe_ffn_dense


if __name__ == "__main__":
    main()
