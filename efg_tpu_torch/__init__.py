"""efg_tpu_torch — the PyTorch/CUDA port of efg_tpu for NVIDIA Hopper.

The layout mirrors `efg_tpu/` module for module. Plain tensor code is
PyTorch; every TPU (Pallas) kernel on a ported path is a hand-written CUDA
C++ kernel under `csrc/`, built with nvcc at first use and bound with
ctypes (`ops/cuda/build.py`). Kernels dispatch by the tensor's device: a
CUDA tensor launches the kernel (or raises), a CPU tensor runs the plain
PyTorch version beside it.

This package never imports jax, flax or efg_tpu.
"""

__version__ = "0.1.0"
