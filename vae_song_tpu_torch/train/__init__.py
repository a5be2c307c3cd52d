"""Eval step, apply functions and checkpoint loading of the PyTorch port."""
