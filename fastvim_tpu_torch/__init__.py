"""FastVim in PyTorch with hand-written CUDA kernels for Hopper (sm_90a).

The counterpart of :mod:`fastvim_tpu`, module for module: the same models,
parameter names and layouts (images NHWC, tokens ``(batch, L, d)`` in
raster order). On a CPU tensor every kernel wrapper runs its plain PyTorch
version; on a CUDA tensor it launches the kernel, built with ``nvcc`` from
``ops/kernels/csrc`` at first use, or raises. This package never imports
JAX.
"""

__version__ = "0.1.0"
