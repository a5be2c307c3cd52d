"""The plain versions of the attention A/B arms (scripts/ab_attn_arms.py:
the exact arms of K2, dfuse, lfuse, bfuse, fused-e16 and fused-e32, and
of K1, bf16max) against the TPU ablation kernels they port
(scripts/ab_attn_ablate8.py, ab_attn_bwd.py, ab_attn_ablate5.py), run in
interpret mode on the same numpy inputs, and against the package's plain
versions; the arms' wrappers on CPU tensors; and that the module, which
chip_smoke.py loads, stands alone.

The TPU scripts are loaded from their files and left as they are: their
call functions import `jax.experimental.pallas` when called and pass no
`interpret`, so the test points `pallas_call` at its interpret mode for
the length of the test.
"""

import functools
import importlib.util
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax_parity import one_thread  # noqa: F401  (the fixture, used below)
from vae_song_tpu.ops import denseattn as jax_denseattn
from vae_song_tpu_torch.ops import denseattn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
pytestmark = pytest.mark.usefixtures("one_thread")

B, N, H, D = 1, 256, 2, 64
BQ = 128                     # two query blocks: the scripts' accumulation runs
SCALE = 1.0 / np.sqrt(D)     # the scripts' SCALE
# test_torch_denseattn.py's bf16 bounds: 2^-6 of max(1, max|ref|) for O and
# for each of dq, dk, dv (bf16 outputs: a few output ulps), 1e-3 of
# max(1, max|LSE2|) (jnp.exp2 on bf16 lowers to exp(bf16(ln 2) x) under
# XLA on the CPU, which the port does not copy).
BF16_TOL, LSE_TOL = 2.0 ** -6, 1e-3


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(ROOT, path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


arms = _load("scripts/ab_attn_arms.py", "ab_attn_arms_under_test")


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in interpret mode while the test runs."""
    import jax.experimental.pallas as pl

    monkeypatch.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))


@functools.lru_cache(maxsize=None)
def _script(name):
    return _load(f"scripts/{name}.py", f"tpu_{name}")


def _inputs(seed):
    rng = np.random.default_rng(seed)
    # q, k scaled by 2: a peaked softmax, as in a trained model
    return [(rng.normal(size=(B, N, H * D)) * s).astype(np.float32) for s in (2.0, 2.0, 1.0, 1.0)]


def _jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _torch(a):
    return torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(
        torch.bfloat16).view(B, N, H, D)


def _lse(lse_a, lse_b):
    """The packed kernels' lse_a / lse_b [B, H/2, N, 1] as [B, H, N] (heads
    2j and 2j + 1)."""
    lse = np.stack([np.asarray(lse_a)[..., 0], np.asarray(lse_b)[..., 0]], axis=2)
    return torch.from_numpy(lse.reshape(B, H, N).copy())


def _np(t):
    return t.float().reshape(B, N, H * D).numpy()


def _within(got, want, tol):
    """max |got - want| over tol max(1, max|want|), each pair."""
    return [float(np.abs(g - w).max() / (tol * max(1.0, np.abs(w).max())))
            for g, w in zip(got, want)]


def _case(seed):
    """The inputs on both sides and the package's packed forward (JAX, in
    interpret mode): q, k, v, do as JAX and port arrays, O, LSE2."""
    q, k, v, do = _inputs(seed)
    jq, jk, jv, jdo = map(_jax, (q, k, v, do))
    o, lse_a, lse_b = jax_denseattn._call_fwd_packed(jq, jk, jv, SCALE, True)
    port = [_torch(a) for a in (jq, jk, jv, jdo)]
    return (jq, jk, jv, jdo, o, lse_a, lse_b), (*port, _torch(o), _lse(lse_a, lse_b))


# (script, the arm's arguments after the inputs) for each exact K2 arm
BWD_SCRIPTS = {
    "dfuse": ("ab_attn_ablate8", dict(fuse_lse=False, fuse_delta=True)),
    "lfuse": ("ab_attn_ablate8", dict(fuse_lse=True, fuse_delta=False)),
    "bfuse": ("ab_attn_ablate8", dict(fuse_lse=True, fuse_delta=True)),
    "fused-e16": ("ab_attn_bwd", dict(exp2_f32=False)),
    "fused-e32": ("ab_attn_bwd", dict(exp2_f32=True)),
}


def _jax_bwd(arm, jq, jk, jv, jdo, o, lse_a, lse_b):
    script, kw = BWD_SCRIPTS[arm]
    mod = _script(script)
    if script == "ab_attn_ablate8":
        return mod.call_bwd_fused(BQ, kw["fuse_lse"], kw["fuse_delta"], jq, jk, jv, jdo, o,
                                  lse_a, lse_b)
    return mod.call_bwd_fused(jq, jk, jv, jdo, o, lse_a, lse_b, SCALE, BQ, kw["exp2_f32"])


@pytest.mark.usefixtures("interpret")
@pytest.mark.parametrize("arm", arms.BWD_EXACT)
def test_bwd_arm_plain_matches_tpu_script(arm):
    jx, (q, k, v, do, o, lse) = _case(seed=len(arm))
    want = [np.asarray(g.astype(jnp.float32)) for g in _jax_bwd(arm, *jx)]
    got = [_np(g) for g in arms.bwd_fold_plain(arm, q, k, v, o, lse, do, SCALE)]
    ratios = _within(got, want, BF16_TOL)
    assert max(ratios) <= 1.0, (arm, ratios)


@pytest.mark.usefixtures("interpret")
def test_fwd_bf16max_plain_matches_tpu_script():
    (jq, jk, jv, *_), (q, k, v, *_) = _case(seed=7)
    o_ref, lse_a, lse_b = _script("ab_attn_ablate5").call_fwd_bf16max(jq, jk, jv, bq=BQ)
    o, lse = arms.fwd_bf16max_plain(q, k, v, SCALE)
    assert _within([_np(o)], [np.asarray(o_ref.astype(jnp.float32))], BF16_TOL)[0] <= 1.0
    assert _within([lse.numpy()], [_lse(lse_a, lse_b).numpy()], LSE_TOL)[0] <= 1.0


# The exact arms against the package's plain versions on the same inputs.
# The folds move the rounding of P's argument and of dP - delta (one
# bf16 rounding fewer): measured at these inputs, dq, dk, dv 0.16-0.80 of
# the bf16 bound above (fused-e32 the farthest), so they are held to it.
# bf16max rounds the scores themselves before the max: at |S2| ~ 25 that
# moves each exponent by up to 2^-9 |S2| ~ 0.05 (P by up to 3.4%), so it
# is a coarser function: measured O 0.99 of 2^-6 of max|O| and LSE2 2.4e-3
# of max|LSE2| (2.4 times LSE_TOL); held to 2^-5 and to 2^-8 of max|LSE2|
# (one bf16 ulp of S2 at that size). An arm that subtracted the wrong
# constant (LSE2 or delta left out, or added) misses them by far more.
@pytest.mark.parametrize("arm", arms.BWD_EXACT)
def test_bwd_arm_plain_near_package_plain(arm):
    _, (q, k, v, do, o, lse) = _case(seed=11)
    want = [_np(g) for g in denseattn.dense_attention_bwd_plain(q, k, v, o, lse, do, SCALE)]
    got = [_np(g) for g in arms.bwd_fold_plain(arm, q, k, v, o, lse, do, SCALE)]
    assert max(_within(got, want, BF16_TOL)) <= 1.0
    # ... and the arm is not the package's function
    assert any(not np.array_equal(g, w) for g, w in zip(got, want))


def test_fwd_bf16max_plain_near_package_plain():
    _, (q, k, v, *_) = _case(seed=13)
    o_ref, lse_ref = denseattn.dense_attention_fwd_plain(q, k, v, SCALE)
    o, lse = arms.fwd_bf16max_plain(q, k, v, SCALE)
    assert _within([_np(o)], [_np(o_ref)], 2.0 ** -5)[0] <= 1.0
    assert _within([lse.numpy()], [lse_ref.numpy()], 2.0 ** -8)[0] <= 1.0
    assert not torch.equal(lse, lse_ref)


@pytest.mark.parametrize("arm", [*arms.BWD_PLAIN, *arms.FWD_PLAIN])
def test_cpu_wrappers_take_the_plain_version(arm):
    _, (q, k, v, do, o, lse) = _case(seed=3)
    before = (dict(arms.bwd_launches), dict(arms.fwd_launches))
    if arm in arms.BWD_ARMS:
        got = arms.attn_bwd_arm(arm, q, k, v, o, lse, do, SCALE)
        want = arms.BWD_PLAIN[arm](q, k, v, o, lse, do, SCALE)
    else:
        got = arms.attn_fwd_arm(arm, q, k, v, SCALE)
        want = arms.FWD_PLAIN[arm](q, k, v, SCALE)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (arms.bwd_launches, arms.fwd_launches) == before


def test_strips_have_no_plain_version():
    _, (q, k, v, do, o, lse) = _case(seed=5)
    for arm in arms.BWD_KEPT:
        with pytest.raises(ValueError, match="no plain version"):
            arms.attn_bwd_arm(arm, q, k, v, o, lse, do, SCALE)
    for arm in arms.FWD_KEPT:
        with pytest.raises(ValueError, match="no plain version"):
            arms.attn_fwd_arm(arm, q, k, v, SCALE)
    with pytest.raises(ValueError, match="unknown"):
        arms.attn_bwd_arm("full", q, k, v, o, lse, do, SCALE)
    # every arm is checked one way: against its plain version, or by the
    # outputs it keeps
    assert set(arms.BWD_KEPT).isdisjoint(arms.BWD_PLAIN)
    assert set(arms.BWD_KEPT) | set(arms.BWD_PLAIN) == set(arms.BWD_ARMS)
    assert set(arms.FWD_KEPT).isdisjoint(arms.FWD_PLAIN)
    assert set(arms.FWD_KEPT) | set(arms.FWD_PLAIN) == set(arms.FWD_ARMS)


_NAME = "_ZN48_GLOBAL__N__789a0329_15_dense_attn_fwd_cu_bb0e39be6kernelILi64EEEvv"
_LOG = f"""ptxas info    : Compiling entry function '{_NAME}' for 'sm_90a'
ptxas info    : Function properties for {_NAME}
    0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compile time = 10.0 ms
"""


def test_compare_reads_ptxas_without_path_hashes():
    """--compare keys each kernel by its mangled name without the hashes
    that the source's path puts into the anonymous namespace, so the
    parent's and this checkout's kernels pair up."""
    got = arms._ptxas_by_function(_LOG)
    moved = _LOG.replace("789a0329", "0123abcd").replace("bb0e39be", "deadbeef")
    assert got == arms._ptxas_by_function(moved) and len(got) == 1
    assert list(got.values())[0] == [
        "0 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads",
        "Used 168 registers, used 1 barriers"]


def _enum(path, name):
    """The enumerators of C++ enum `name` in `path`, in order."""
    src = open(os.path.join(ROOT, path)).read()
    body = re.search(r"enum %s : int \{(.*?)\};" % name, src, re.S).group(1)
    return [e.split("=")[0].strip() for e in body.replace("\n", " ").split(",") if e.strip()]


def test_arm_codes_match_the_sources():
    bwd = _enum("vae_song_tpu_torch/csrc/dense_attn_bwd.cu", "BwdArm")
    fwd = _enum("vae_song_tpu_torch/csrc/dense_attn_fwd.cu", "FwdArm")
    bwd_names = ["Dfuse", "Lfuse", "Bfuse", "FusedE16", "FusedE32", "NoExp", "NoDp",
                 "NoDsMul", "NoDq", "NoDk", "Rows64"]
    assert [bwd.index("kBwd" + n) for n in bwd_names] == list(arms.BWD_ARMS.values())
    assert bwd[0] == "kBwdFull" and bwd[-1] == "kBwdArms"
    fwd_names = {"bf16max": "Bf16Max", "noexp": "NoExp", "nomax": "NoMax", "nopv": "NoPv",
                 "sonly": "SOnly", "nc1": "Full", "nc2": "Full"}
    assert {a: fwd.index("kFwd" + n) for a, n in fwd_names.items()} == {
        a: code for a, (code, _nc) in arms.FWD_ARMS.items()}


def test_families_name_the_tpu_functions():
    """Each family's `replaces` is the line of a function of that script
    whose body reaches pl.pallas_call; together the families cover every
    arm once."""
    for _name, replaces, part, members in arms.FAMILIES:
        path, line = replaces.split(":")
        lines = open(os.path.join(ROOT, path)).read().splitlines()
        assert lines[int(line) - 1].startswith("def "), replaces
        body = []
        for text in lines[int(line):]:
            if text.startswith("def "):
                break
            body.append(text)
        assert "pl.pallas_call(" in "\n".join(body), replaces
        assert set(members) <= set(arms.BWD_ARMS if part == "bwd" else arms.FWD_ARMS)
    covered = [(p, m) for *_, p, ms in arms.FAMILIES for m in ms]
    assert sorted(covered) == sorted([("bwd", a) for a in arms.BWD_ARMS]
                                     + [("fwd", a) for a in arms.FWD_ARMS])


_IMPORT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("arms", "scripts/ab_attn_arms.py")
mod = importlib.util.module_from_spec(spec)
spec.loader.exec_module(mod)
roots = ("jax", "jaxlib", "flax", "optax", "vae_song_tpu")
bad = sorted(m for m in sys.modules if m.split(".")[0] in roots)
assert not bad, bad
assert mod._lib is None and mod._kernels._lib is None, "a library was loaded at import"
print("ok")
"""


def test_module_stands_alone():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _IMPORT], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-2000:]
