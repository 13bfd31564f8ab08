"""Peaks of one NVIDIA H100 SXM 80 GB (NVIDIA's data sheet, dense rates
without sparsity, at the full 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
FLOPS = {
    "bf16": 989e12,     # tensor cores, bf16 and fp16 operands
    "tf32": 495e12,
    "f32": 67e12,       # outside the tensor cores
}
