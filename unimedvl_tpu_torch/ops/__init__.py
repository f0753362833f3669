"""Ops of the port: plain PyTorch functions on tensors, and the wrappers of the
hand-written CUDA kernels (flash_attention.py: K1a and K1b, decode_attention.py: K2)."""
