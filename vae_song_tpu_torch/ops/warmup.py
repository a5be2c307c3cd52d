"""Alpha warmup schedules (port of vae_song_tpu/ops/warmup.py, copied:
importing it would pull in jax; model.py:37-63 of the reference).

The reference mutates `model.wu_alpha` each epoch; here the schedules
are pure functions of (previous alpha, epoch, ...) evaluated on the host
once per epoch, and the resulting scalar is fed into the train step.

Strategies:
  * linear:        alpha += 1/(max_epoch - start_epoch + 1) (or up_amount),
                   clipped to [., 1.0], active from start_epoch
  * exponential:   alpha = clip(exp(x) - 1, 0, 1) with
                   x = (epoch-start)*ln(2)/(max-start) (or up_amount*(epoch-start))
  * repeat_linear: alpha = min(1/((epoch % repeat_interval) + 1), 1)
  * kl_adaptive:   alpha = sigmoid(5 - last_kl) = 1/(1 + exp(last_kl - 5))
"""

import math

STRATEGIES = ("linear", "exponential", "repeat_linear", "kl_adaptive")


def warmup_alpha(
    prev_alpha: float,
    epoch: int,
    max_epoch: int,
    wu_strat: str = "linear",
    up_amount: float | None = None,
    start_epoch: int = 0,
    repeat_interval: int = 10,
    last_kl_loss: float = 0.0,
) -> float:
    if epoch < start_epoch:
        return prev_alpha
    if wu_strat == "linear":
        step = up_amount if up_amount is not None else 1.0 / (max_epoch - start_epoch + 1)
        return min(prev_alpha + step, 1.0)
    if wu_strat == "exponential":
        if up_amount is None:
            x = (epoch - start_epoch) * math.log(2) / (max_epoch - start_epoch)
        else:
            x = up_amount * (epoch - start_epoch)
        return max(min(math.exp(x) - 1.0, 1.0), 0.0)
    if wu_strat == "repeat_linear":
        return min(1.0 / ((epoch % repeat_interval) + 1), 1.0)
    if wu_strat == "kl_adaptive":
        # shifted inverted sigmoid of the last observed KL (model.py:62)
        z = last_kl_loss - 5.0
        # numerically safe sigmoid
        if z >= 0:
            return math.exp(-z) / (1.0 + math.exp(-z))
        return 1.0 / (1.0 + math.exp(z))
    raise ValueError(f"Unknown warmup strategy: {wu_strat}")
