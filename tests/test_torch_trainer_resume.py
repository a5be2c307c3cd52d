"""The trainer's resume path on the CPU: `resume_from` replays the
continuous run bit for bit, with and without the warmup state in the
checkpoint. The helpers are tests/test_torch_trainer_options.py's; the
runs sit in a file of their own so that pytest-xdist's --dist loadfile
puts them on another worker than that file's."""

import os
import pickle

import pytest
import torch

from test_torch_trainer_options import (ALPHA, BETA, RUN_ATTN, RUN_DEEPSETS, _assert_same_state,
                                        _ckpts, _trainer_kw)
from vae_song_tpu_torch.models.registry import build_model
from vae_song_tpu_torch.train.loop import train_and_test

from jax_parity import one_thread  # noqa: F401 (the fixture, used below)

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.mark.parametrize("mp,options", [
    (RUN_ATTN, {"checkpoint_every": 1}),
    (RUN_DEEPSETS, {"checkpoint_every": 1, "async_checkpoint": True, "grad_accum": 2}),
    (dict(RUN_ATTN, attn_dropout=0.1), {"checkpoint_every": 2}),
])
def test_resume_replays_the_continuous_run(tmp_path, mp, options):
    """SetLRVAE under kl_adaptive for 3 epochs with checkpoints, then a
    fresh model (other weights) resumed from the first checkpoint: its
    final parameters, statistics and optimizer state equal the
    continuous run's bit for bit (per-epoch seeding of every stream, the
    dropout masks' included, and the warmup state from `extra`)."""
    mk = lambda seed: build_model("setlrvae", "shapenet", mp, beta=BETA, alpha=ALPHA,
                                  generator=torch.Generator().manual_seed(seed))
    cont, _ = train_and_test(mk(0), **_trainer_kw(tmp_path / "a", **options))
    ckpts = _ckpts(tmp_path / "a")
    every = options["checkpoint_every"]
    assert [os.path.basename(c) for c in ckpts] == [
        f"ckpt_{e}.pkl" for e in range(3) if (e + 1) % every == 0]
    with open(ckpts[0], "rb") as f:
        extra = pickle.load(f)["extra"]
    assert extra["last_kl"] > 0.0 and extra["wu_alpha"] > 0.0
    resumed, _ = train_and_test(mk(7), resume_from=ckpts[0],
                                **_trainer_kw(tmp_path / "b", **{k: v for k, v in options.items()
                                                                 if k == "grad_accum"}))
    assert resumed.step == cont.step == 3 * 2
    _assert_same_state(cont, resumed)


def test_resume_without_warmup_state_replays_the_schedule(tmp_path):
    """A checkpoint whose `extra` lacks the warmup state: the resumed run
    replays the deterministic schedule from epoch 0, as the JAX trainer
    does, and under `linear` ends where the continuous run ends."""
    mk = lambda seed: build_model("setlrvae", "shapenet", RUN_ATTN, beta=BETA, alpha=ALPHA,
                                  generator=torch.Generator().manual_seed(seed))
    kw = dict(_trainer_kw(tmp_path / "a"), wu_strat="linear")
    cont, _ = train_and_test(mk(0), checkpoint_every=1, **kw)
    path = _ckpts(tmp_path / "a")[1]
    with open(path, "rb") as f:
        payload = pickle.load(f)
    payload["extra"] = {}
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    resumed, _ = train_and_test(mk(7), resume_from=path,
                                **dict(kw, output_root=str(tmp_path / "b")))
    _assert_same_state(cont, resumed)
