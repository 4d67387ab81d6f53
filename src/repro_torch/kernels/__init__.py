"""Hand-written Hopper kernels of the port, with their plain versions.

``phi`` — Φ^(n) and the fused Φ -> MU step on the blocked layout
(CUDA C++ in ``csrc/phi.cu``).  Sources are built with nvcc at first use
(``_build``); importing this package builds and loads nothing.
"""
