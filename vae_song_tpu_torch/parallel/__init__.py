"""Sweeps and the single-device half of the JAX package's vae_song_tpu/
parallel (port): the Lipschitz sweep runner (sweep.py) and the MoE FFN's
routing evaluated on one device (ep.py). The parallel training
strategies wait for ROADMAP.md Queue 1 item 15."""
