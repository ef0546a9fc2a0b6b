"""Attention: dispatch, the fused CUDA kernel wrapper, plain versions."""
