"""diffusion sub-package of the PyTorch port."""
