"""The port's Lipschitz CLI analysis stage against JAX's pipeline on the
CPU for the LR-VAE, the model of the paper's alpha trade-off: JAX's
`cli.lipschitz.main` trains and analyses at a small size, its trained
parameters are carried into the port, and the port's analysis stage on
JAX's draws gives JAX's fields and data-based metrics
(jax_parity.check_lipschitz_analysis; LIDVAE's run is in
tests/test_torch_lipschitz_cli.py)."""

from jax_parity import (LIPSCHITZ_ARGS, LIPSCHITZ_SMALL, check_lipschitz_analysis,
                        lipschitz_jax_run)


def test_analysis_stage_matches_jax(tmp_path):
    argv = LIPSCHITZ_SMALL + LIPSCHITZ_ARGS["lrvae"]
    check_lipschitz_analysis(lipschitz_jax_run(argv, tmp_path / "run"), argv)
