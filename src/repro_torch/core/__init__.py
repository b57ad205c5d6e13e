"""Core: the paper's contribution as composable PyTorch functions.

fixedpoint  - Q8.24 arithmetic (ALU_TO_FIXED / ALU_TO_FLOAT)
lut         - the 2.69 kB ROM tables (eqs 11-13)
approx      - LUT softmax / GELU dispatchers (Table VII behaviours)
quant       - power-of-2 PTQ (eq 9), QTensor, integer matmul
tree        - nested dict/list parameter-tree helpers
"""

from repro_torch.core import approx, fixedpoint, lut, quant, tree  # noqa: F401
