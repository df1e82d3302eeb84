"""PyTorch/CUDA port of ``generative_turbulence_tpu`` for NVIDIA Hopper GPUs.

Sub-packages mirror the JAX package's layout; public functions keep its
channels-last ``(B, X, Y, Z, F)`` layout.  Importing the package imports no
JAX and no h5py.
"""
