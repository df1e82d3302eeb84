"""parallel sub-package of the PyTorch port: the multi-process runtime over
``torch.distributed`` and the data-parallel layout of batches and draws."""
