"""The PyTorch port stands alone: no module of vae_song_tpu_torch and
nothing chip_smoke.py imports pulls in jax or the JAX package (the
machine with the card has neither), chip_smoke.py's MODEL_PARAMS is the
shipped config's, and chip_smoke.py refuses to report a result without
a CUDA card or without the rest of the repository. Its further
configurations are the shipped ones with one stated change each."""

import ast
import os
import shutil
import subprocess
import sys

from vae_song_tpu.config import load_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(ROOT, "chip_smoke.py")

_IMPORT_ALL = """
import importlib, pkgutil, sys
import vae_song_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
from vae_song_tpu_torch import _kernels
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "vae_song_tpu"))
assert not bad, bad
assert _kernels._lib is None, "a kernel library was loaded at import"
print(" ".join(names))
print(len(names))
"""
# the LID-VAE / Lipschitz slice's modules and the image slice's, each of
# which must be among them
SLICE_MODULES = {"vae_song_tpu_torch." + m for m in (
    "analysis", "models.lidvae", "ops.lipschitz", "train.scan", "cli.lipschitz", "cli.figures",
    "parallel", "parallel.sweep", "viz.plots", "nn.blocks",
    "data.images", "data.native", "data.pipeline", "ops.fid", "ops.inception", "viz.pca",
    "cli.generate", "train.loop")}


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_no_jax():
    proc = _run(["-c", _IMPORT_ALL], ROOT, {"PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20     # every module was imported
    assert SLICE_MODULES <= set(proc.stdout.splitlines()[-2].split())


def test_chip_smoke_imports_no_jax():
    tree = ast.parse(open(SMOKE).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module)
    roots = {m.split(".")[0] for m in mods}
    assert not roots & {"jax", "jaxlib", "flax", "optax", "vae_song_tpu", "yaml"}, roots
    assert "vae_song_tpu_torch" in roots


def _smoke_literal(name):
    """The literal value chip_smoke.py assigns to the module constant `name`."""
    tree = ast.parse(open(SMOKE).read())
    return ast.literal_eval(next(
        node.value for node in tree.body
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == name for t in node.targets)
    ))


def _smoke_function(name):
    tree = ast.parse(open(SMOKE).read())
    return ast.unparse(next(node for node in tree.body
                            if isinstance(node, ast.FunctionDef) and node.name == name))


def test_chip_smoke_model_params_are_the_shipped_config():
    """MODEL_PARAMS and COMMON_PARAMS are the SetVAE config's; MODEL_PARAMS
    updated with SETLRVAE_PARAMS, and SETLRVAE_BATCH, are the SetLRVAE
    config's."""
    literal = _smoke_literal
    config = load_config(os.path.join(ROOT, "configs", "config_shapenet_setvae.yaml"))
    assert literal("MODEL_PARAMS") == config["model_params"]
    assert literal("COMMON_PARAMS") == config["common_params"]
    lr_config = load_config(os.path.join(ROOT, "configs", "config_shapenet_setlrvae.yaml"))
    assert dict(literal("MODEL_PARAMS"), **literal("SETLRVAE_PARAMS")) == lr_config["model_params"]
    assert literal("SETLRVAE_BATCH") == lr_config["common_params"]["batch_size"]


def test_chip_smoke_new_paths_are_shipped_configs_with_one_override(monkeypatch):
    """Phase 4c's configurations are the shipped files plus one stated
    change each and nothing else: the SetVAE config with `num_heads: 2`
    (a key the file sets, to a value that takes the BHND route), and the
    SetVAE and SetLRVAE configs as they are, under the VST_FUSED_FFN
    switch that the port reads."""
    from vae_song_tpu_torch.models import setvae
    from vae_song_tpu_torch.ops import denseattn

    config = load_config(os.path.join(ROOT, "configs", "config_shapenet_setvae.yaml"))
    mp = config["model_params"]
    override = _smoke_literal("HEADS2_OVERRIDE")
    assert override == {"num_heads": 2} and set(override) <= set(mp)
    heads2 = dict(mp, **override)
    n, d = heads2["num_points"], heads2["d_model"] // heads2["num_heads"]
    assert denseattn.dense_ok(n, n, d) and not denseattn.packed_ok(n, n, heads2["num_heads"], d)
    assert "params = dict(MODEL_PARAMS, **HEADS2_OVERRIDE)" in _smoke_function("phase_heads2")

    env = _smoke_literal("FUSED_FFN_ENV")
    assert env == {"VST_FUSED_FFN": "1"}
    monkeypatch.delenv("VST_FUSED_FFN", raising=False)
    assert not setvae._ffn_fused_on()
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert setvae._ffn_fused_on()
    fused = _smoke_function("phase_fused_ffn")
    assert "with mock.patch.dict(os.environ, FUSED_FFN_ENV):" in fused
    assert "lr_params = dict(MODEL_PARAMS, **SETLRVAE_PARAMS)" in fused
    assert "_time_train_step('setvae', MODEL_PARAMS, BATCH, dev, tag)" in fused
    assert "_time_train_step('setlrvae', lr_params, SETLRVAE_BATCH, dev, tag)" in fused


def test_chip_smoke_slice_paths_are_shipped_configs_with_one_override():
    """Phases 6-8 run the shipped SetVAE config with one stated change
    each: `use_attention: false` (the DeepSets models at the file's own
    encoder_hidden / decoder_hidden widths), `attn_dropout: 0.1`, and the
    trainer options (keys the trainer takes) on the config as it is."""
    import inspect

    from vae_song_tpu_torch.train.loop import train_and_test

    config = load_config(os.path.join(ROOT, "configs", "config_shapenet_setvae.yaml"))
    mp = config["model_params"]
    for name, want in (("DEEPSETS_OVERRIDE", {"use_attention": False}),
                       ("DROPOUT_OVERRIDE", {"attn_dropout": 0.1})):
        override = _smoke_literal(name)
        assert override == want and set(override) <= set(mp)
        assert f"params = dict(MODEL_PARAMS, **{name})" in _smoke_function(
            "phase_deepsets" if name == "DEEPSETS_OVERRIDE" else "phase_dropout")
    assert mp["encoder_hidden"] == [128, 256, 512] and mp["decoder_hidden"] == [512, 256, 128]
    options = _smoke_literal("TRAINER_OPTIONS")
    assert options == {"checkpoint_every": 1, "async_checkpoint": True, "grad_accum": 2}
    assert set(options) <= set(inspect.signature(train_and_test).parameters)
    assert config["common_params"]["batch_size"] % options["grad_accum"] == 0


def test_chip_smoke_flexible_configs_are_the_shipped_files():
    """Phase 9's PINWHEEL_CONFIG is configs/config_pinwheel.yaml and
    MNIST_PARAMS / MNIST_BATCH configs/config_mnist.yaml's; CONV_VAE_PARAMS
    is the JAX benchmark's model (bench.py:72)."""
    assert _smoke_literal("PINWHEEL_CONFIG") == load_config(
        os.path.join(ROOT, "configs", "config_pinwheel.yaml"))
    mnist = load_config(os.path.join(ROOT, "configs", "config_mnist.yaml"))
    assert _smoke_literal("MNIST_PARAMS") == mnist["model_params"]
    assert _smoke_literal("MNIST_BATCH") == mnist["common_params"]["batch_size"]
    assert _smoke_literal("CONV_VAE_PARAMS") == {"encoder_type": "conv", "decoder_type": "mlp"}
    bench = open(os.path.join(ROOT, "bench.py")).read()
    assert ('VanillaVAE.for_dataset("mnist", encoder_type="conv", decoder_type="mlp",'
            in bench)
    assert _smoke_literal("CONV_VAE_BATCH") == 256 and "BATCH = 256" in bench


def test_chip_smoke_image_config_is_the_shipped_file():
    """Phase 11's MNIST_CONFIG is configs/config_mnist.yaml, run on the
    stand-in images the file's own comment names (dataset_params {fake:
    true}); the conv VAE it trains on CIFAR-10's stand-ins is bench.py:72's
    model (CONV_VAE_PARAMS, held above) built for cifar10."""
    assert _smoke_literal("MNIST_CONFIG") == load_config(
        os.path.join(ROOT, "configs", "config_mnist.yaml"))
    assert _smoke_literal("MNIST_DATASET") == {"fake": True}
    assert "#   fake: true" in open(os.path.join(ROOT, "configs", "config_mnist.yaml")).read()
    assert "build_model('vae', 'cifar10', CONV_VAE_PARAMS" in _smoke_function("phase_images")


def test_fid_weights_load_with_numpy_alone():
    """The random-conv FID weights the port carries are a plain .npz: numpy
    reads them in a process that imports neither torch nor jax."""
    code = ("import sys, numpy as np\n"
            "z = np.load('vae_song_tpu_torch/ops/fid_conv_seed0.npz')\n"
            "assert sorted(z.files) == sorted(f'c{c}_{k}' for c in (1, 3) for k in "
            "('conv0', 'conv1', 'conv2', 'proj')), z.files\n"
            "assert z['c1_conv0'].shape == (3, 3, 1, 8) and z['c3_proj'].shape == (32, 64)\n"
            "assert not {'torch', 'jax'} & set(sys.modules)\n"
            "print(sum(z[k].nbytes for k in z.files))")
    proc = _run(["-c", code], ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert 0 < int(proc.stdout.split()[-1]) < 100_000


def test_chip_smoke_fails_without_cuda_and_alone(tmp_path):
    """No CUDA card here: non-zero exit, no result line. In a directory
    holding only chip_smoke.py: non-zero exit too."""
    proc = _run([SMOKE], ROOT, {"PYTHONPATH": ROOT, "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    shutil.copy(SMOKE, tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
