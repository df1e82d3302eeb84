"""data sub-package of the PyTorch port."""
