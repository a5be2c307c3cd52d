"""Point-cloud export of the PyTorch port."""
