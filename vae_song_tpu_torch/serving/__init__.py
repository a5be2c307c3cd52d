"""Serving-path utilities of the port: int8 post-training quantisation of
the dense layers for decoding (quant.py)."""
