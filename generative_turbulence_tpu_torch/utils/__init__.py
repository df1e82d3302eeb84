"""utils sub-package of the PyTorch port."""
