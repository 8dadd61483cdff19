"""The hand-written CUDA kernels of the port and their plain PyTorch versions.

Each module holds `<name>_plain` (PyTorch) and the wrapper `<name>`, which
runs the plain version for CPU tensors and launches the kernel for CUDA
tensors, counting launches in `<name>.launches`. `kernels` builds and loads
the shared library from `voxtpu_torch/csrc/`. `ct_fft` holds no kernel: it
is the "ct" backend's chain of matmuls, which voxtpu too leaves to its
compiler's matrix products.
"""
