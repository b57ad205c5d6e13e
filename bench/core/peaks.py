"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet; dense
rates, no sparsity), the yardstick of every roofline and ``mfu`` share.
They assume the card's full 700 W power limit; a run prints the card's
name, and ``PERF.md`` its power limit, beside each share."""

HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989.4e12       # dense bf16 / fp16 tensor cores
TF32_FLOPS = 494.7e12
# a float32 product on the tensor cores taken as three TF32 products
# (3xTF32), as the port's attention kernels take it
F32_3XTF32_FLOPS = TF32_FLOPS / 3
INT8_OPS = 1978.9e12
