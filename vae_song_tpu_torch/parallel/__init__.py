"""Sweeps of the PyTorch port (vae_song_tpu/parallel counterpart): the
Lipschitz sweep runner, parallel/sweep.py. The parallel training
strategies wait for ROADMAP.md Queue 1 item 15."""
