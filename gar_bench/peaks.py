"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates
without sparsity, at the 700 W power limit)."""

HBM_BYTES_PER_S = 3.35e12
# math rate by the precision a configuration states for its convolutions
FLOPS_PER_S = {"bfloat16": 989e12, "tf32": 495e12, "float32": 67e12}
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
