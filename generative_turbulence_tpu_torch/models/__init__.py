"""models sub-package of the PyTorch port."""
