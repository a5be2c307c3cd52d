"""Ops of the PyTorch port: attention, Chamfer, losses; the hand-written
kernels sit behind ops/denseattn.py and ops/chamfer.py."""
