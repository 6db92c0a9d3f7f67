"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at its full 700 W power limit; a card set below it runs slower,
and every run prints the card's limit)."""

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
