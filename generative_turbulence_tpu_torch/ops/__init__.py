"""ops sub-package of the PyTorch port."""
