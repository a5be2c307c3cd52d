"""vae_song_tpu_torch: the PyTorch / CUDA port of vae_song_tpu for one
NVIDIA Hopper card (H100, sm_90a).

The JAX package vae_song_tpu stays the reference; this package never
imports it, nor jax. Ported so far: the SetVAE / SetLRVAE inference path
(eval step and generation) with hand-written CUDA kernels for the dense
attention forward (ops/denseattn.py) and the Chamfer forward
(ops/chamfer.py), built from csrc/ at first use (_kernels.py).
"""
