"""PyTorch/CUDA port of GIMS (graph-based image matching).

Mirrors the JAX package ``gims_tpu`` module by module. Plain tensor code is
PyTorch; the two kernels that the JAX package wrote for the TPU are CUDA C++
for Hopper under ``csrc/``, built with ``nvcc`` at first use
(``_build.py``). The package imports neither JAX nor the JAX package.
"""
