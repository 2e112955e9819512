"""Hand-written Hopper kernels and their plain PyTorch versions.

Each wrapper launches its CUDA kernel for a CUDA tensor and runs its plain
version for a CPU tensor.  The CUDA sources live in ``csrc/`` and are built
with nvcc at first use (``kernels/_build.py``).
"""
