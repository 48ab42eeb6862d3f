"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch version.

``integrate_cuda``, ``coloration_cuda`` and ``sparse_cuda`` dispatch on the
device of the tensors they are given: a CPU tensor runs the plain version, a CUDA tensor
launches the kernel (built from ``csrc/`` at first use) or raises.
"""
