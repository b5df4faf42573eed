"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W power limit): what roofline shares are taken
against. A card set below 700 W reaches less; the run's stderr names the
card and its limit."""

FP32_FLOPS = 67e12          # FP32 outside the tensor cores
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12   # 80 GB HBM3
HBM_BYTES = 80e9
