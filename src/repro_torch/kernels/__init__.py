"""Hand-written CUDA kernels for Hopper and their wrappers.

``ops`` holds the public wrappers (any leading dims); each kernel module
(``lut_softmax``, ``lut_gelu``, ``int8_matmul``, ``lut_attention``) holds
the wrapper that launches the kernel, its launch counter, and takes the plain
PyTorch version of ``ref`` only for a tensor that lies on the CPU.  The
CUDA sources are in ``repro_torch/csrc`` and are compiled by ``build``
at the first launch — importing this package touches no compiler.
"""
