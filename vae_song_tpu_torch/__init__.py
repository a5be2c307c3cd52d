"""vae_song_tpu_torch: the PyTorch / CUDA port of vae_song_tpu for one
NVIDIA Hopper card (H100, sm_90a).

The JAX package vae_song_tpu stays the reference; this package never
imports it, nor jax. Ported so far: the SetVAE / SetLRVAE models (the
transformer and the DeepSets variants), their training (train/) and
generation (cli/); the FlexibleVAE family and LID-VAE (models/) with the
Lipschitz/KL analysis (analysis.py, cli/lipschitz.py, parallel/sweep.py);
hand-written CUDA kernels for the dense attention
(ops/denseattn.py), the Chamfer loss (ops/chamfer.py) and the fused FFN
(ops/ffn.py), built from csrc/ at first use (_kernels.py).
"""
