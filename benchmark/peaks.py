"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at
the full 700 W power limit)."""

BF16_FLOPS = 989e12  # bf16 / fp16 on the tensor cores
FP32_FLOPS = 67e12  # fp32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
