"""omnihuman_tpu_torch: the PyTorch / CUDA port of omnihuman_tpu for one
NVIDIA H100.

Plain tensor code is PyTorch; every Pallas TPU kernel on a ported path is
a hand-written Hopper kernel under `csrc/`, built with nvcc at first use.
The JAX package `omnihuman_tpu` stays the reference the port is tested
against; this package imports neither it nor JAX.
"""
