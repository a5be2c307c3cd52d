"""Layers of the PyTorch port (vae_song_tpu/nn counterpart)."""
