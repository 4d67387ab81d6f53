"""Hand-written Hopper kernels of the port, with their plain versions.

``phi`` — Φ^(n) and the fused Φ -> MU step on the blocked layout
(CUDA C++ in ``csrc/phi.cu``); ``mttkrp`` — sparse MTTKRP on the same
layout (``csrc/mttkrp.cu``); ``pi`` — the Π rows both read, formed in
the layout's slot order (``csrc/pi.cu``); ``dense`` — the matrix-free
dense Φ, fused Φ -> MU step and MTTKRP (``csrc/dense.cu``); ``stream``
— the STREAM copy, scale, add and triad (``csrc/stream.cu``).  Sources
are built with nvcc at first use (``_build``); importing this package
builds and loads nothing.
"""
