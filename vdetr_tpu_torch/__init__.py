"""vdetr_tpu_torch: the V-DETR eval forward in PyTorch on an NVIDIA H100.

A port of `vdetr_tpu` (JAX on a TPU), which stays in the repository as
the reference. Module names mirror `vdetr_tpu/` so each counterpart is
easy to find. The three Pallas kernels of the eval forward become CUDA
C++ kernels for Hopper (`csrc/`), each with a plain PyTorch version in
the module that wraps it: a wrapper launches its kernel on CUDA tensors
and takes the plain version only for tensors on the CPU.

The package imports torch and numpy, and from `vdetr_tpu` only the two
jax-free modules `vdetr_tpu.config` and `vdetr_tpu.train.torch_import`.
"""

__version__ = "0.1.0"
