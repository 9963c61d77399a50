"""Hand-written Hopper kernels and their wrappers.

Each wrapper module holds the kernel's plain PyTorch version, a launch count
(``<wrapper>.launches``) and the ctypes binding of its ``csrc/*.cu`` source.
A wrapper runs the plain version only for tensors on the CPU; for a CUDA
tensor it launches the kernel or raises.  The inference kernels (rows 1, 2
and 5) are ``torch.library`` operators in the ``ip_avsr`` namespace, which
an exported program (``ip_avsr_torch.export``) records and, once loaded,
launches; importing ``lstm`` and ``delta`` registers them.
"""
