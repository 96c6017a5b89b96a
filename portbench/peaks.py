"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit), the yardstick of every roofline
share the benchmark reports."""

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12  # fp32 outside the tensor cores
# int32 on the CUDA cores runs at half the fp32 rate (64 of 128 lanes an SM
# a clock on Hopper)
INT32_OPS_PER_S = FP32_OPS_PER_S / 2
