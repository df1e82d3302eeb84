"""The port's evaluation entry points, one module per script of ``scripts/``
(``-`` as ``_``), each run as ``python -m generative_turbulence_tpu_torch.scripts.<name>``."""
