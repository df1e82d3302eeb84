"""toolchain sub-package of the PyTorch port."""
