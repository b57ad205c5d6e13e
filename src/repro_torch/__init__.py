"""KWT-Tiny in PyTorch + CUDA: the port of ``repro`` (the JAX package).

Same sub-packages and function names as the reference so a reader finds
the counterpart; plain functions on tensors and plain dict parameter
trees inside.  This package imports ``torch`` and ``numpy`` only — never
``jax`` and nothing of ``repro``.  The hand-written CUDA kernels live in
``csrc/`` and are compiled at their first launch on a CUDA tensor
(``kernels/build.py``); importing the package touches no compiler.
"""
