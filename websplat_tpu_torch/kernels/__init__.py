"""nvcc build and ctypes binding of the CUDA kernels in ../csrc."""
