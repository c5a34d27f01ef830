"""linevis_tpu_torch: the PyTorch/CUDA port of linevis_tpu for NVIDIA Hopper.

Mirrors the module layout of `linevis_tpu` so each module's counterpart is
found by its path. Plain tensor code is PyTorch; every Pallas TPU kernel on a
ported path is a hand-written CUDA kernel under `kernels/csrc/`, built with
nvcc at first use (`kernels/_build.py`). On a CPU tensor each kernel wrapper
runs its plain PyTorch version instead, which is what the CPU tests check
against the JAX package.

The package imports neither `jax` nor anything of `linevis_tpu`.
"""
