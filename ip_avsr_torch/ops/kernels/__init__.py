"""Hand-written Hopper kernels and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, a launch count
(``<wrapper>.launches``) and the ctypes binding of its ``csrc/*.cu`` source.
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.
"""
