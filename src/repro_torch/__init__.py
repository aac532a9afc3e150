"""PyTorch/CUDA port of the HAPM reproduction: int8 group-sparse ResNet
serving on NVIDIA Hopper through hand-written CUDA kernels.

Same sub-package layout and the same module and function names as the
JAX package ``repro`` that lives beside it, so a reader finds a
counterpart by path. This package imports ``torch`` and ``numpy`` only.
"""
