"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates without sparsity), at the full 700 W power limit. Every result
line carries the card's name and the run prints its power limit beside
them (``nvidia-smi``): a card set below 700 W runs slower under load,
and its shares read lower against these peaks."""

H100 = {
    "bf16_flops": 989e12,     # dense bf16 / fp16 tensor-core FLOP/s
    "hbm_bytes_s": 3.35e12,   # HBM3 bandwidth, bytes/s
}
