"""Published peaks of the card, from NVIDIA's H100 SXM data sheet (dense
rates, no sparsity, at the full 700 W power limit)."""

H100_SXM = {
    "bf16_flops": 989e12,
    "hbm_bytes_per_s": 3.35e12,
}
