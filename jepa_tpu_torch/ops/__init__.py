"""Attention, fused MLP and token-gather ops; CUDA kernel wrappers."""
