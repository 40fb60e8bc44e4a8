"""Scoring ops of the flat scan: exact top-k and the fused score+top-k
kernel (CUDA for tensors on the card, its plain PyTorch version on the CPU)."""
