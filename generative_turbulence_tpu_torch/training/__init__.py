"""training sub-package of the PyTorch port."""
