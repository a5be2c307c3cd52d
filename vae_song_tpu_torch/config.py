"""YAML config loading (port of vae_song_tpu/config.py, copied): the
reference's schema, top-level `experiment_type`, `common_params`,
`model_params`, with hyperparameter *lists* defining sweep grids.
`yaml` is imported where a file is read, so the rest of the module works
on machines without pyyaml."""

import itertools


def load_config(config_path: str) -> dict:
    import yaml

    with open(config_path, "r") as f:
        return yaml.safe_load(f)


def experiment_fingerprint(config: dict) -> str:
    """Result/log-name fingerprint (main.py:403-417)."""
    exp_type = config["experiment_type"]
    common = config["common_params"]
    mp = config["model_params"]
    str_res = "_res" if mp.get("residual_connection") else ""
    return (
        f"{common['exp_data']}_{exp_type}{str_res}"
        f"_depth{len(mp.get('hchans') or [])}"
        f"_mc{mp.get('num_mc_samples', 1)}"
    )


def resolve_names(config: dict):
    """(logfilename, resultname) with fingerprint fallbacks
    (main.py:409-417)."""
    common = config["common_params"]
    fp = experiment_fingerprint(config)
    logfilename = common.get("logfilename") or f"log_{fp}.csv"
    resultname = common.get("resultname") or f"result_{fp}"
    return logfilename, resultname


def sweep_grid(config: dict):
    """Yield sweep points as dicts {beta, alpha, il, rep} following the
    per-experiment grid semantics of main.py:422-580."""
    exp_type = config["experiment_type"]
    common = config["common_params"]
    mp = config["model_params"]
    niter = common.get("niter", 1)

    if exp_type == "lidvae":
        grid = itertools.product(mp["beta_list"], mp["il_list"], range(niter))
        for beta, il, rep in grid:
            yield dict(beta=beta, alpha=0.0, il=il, rep=rep)
    elif exp_type in ("vae",):
        for beta, rep in itertools.product(mp["beta_list"], range(niter)):
            yield dict(beta=beta, alpha=0.0, il=0.0, rep=rep)
    elif exp_type == "nae":
        for rep in range(niter):
            yield dict(beta=1.0, alpha=0.0, il=0.0, rep=rep)
    elif exp_type == "lrvae":
        grid = itertools.product(mp["alpha_list"], mp["beta_list"], range(niter))
        for alpha, beta, rep in grid:
            yield dict(beta=beta, alpha=alpha, il=0.0, rep=rep)
    elif exp_type == "setvae":
        for beta, rep in itertools.product(mp.get("beta_list", [1.0]), range(niter)):
            yield dict(beta=beta, alpha=0.0, il=0.0, rep=rep)
    elif exp_type == "setlrvae":
        grid = itertools.product(
            mp.get("alpha_list", [0.01]), mp.get("beta_list", [1.0]), range(niter)
        )
        for alpha, beta, rep in grid:
            yield dict(beta=beta, alpha=alpha, il=0.0, rep=rep)
    else:
        raise ValueError(f"Unsupported experiment type: {exp_type}")
