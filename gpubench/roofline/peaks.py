"""Published dense peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's
data sheet, without sparsity). A card set below 700 W runs below them; the
result names the card."""

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "f32": 67e12}
# Exponentials (MUFU.EX2) an SM issues a clock on Hopper.
SFU_EX2_PER_CLOCK = 16
# The precision a configuration states -> the peak its model's FLOP run at:
# float32 with TF32 off on the CUDA cores, bfloat16 on the tensor cores.
PEAK_OF_PRECISION = {"float32": "f32", "bfloat16": "bf16"}
