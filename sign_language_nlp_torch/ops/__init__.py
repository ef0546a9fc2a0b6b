"""Attention: dispatch, the fused CUDA kernels' wrappers, plain versions;
the single-head fused attention op `fused_attention_bh.fused_attention_bh`
(K3); dropout, losses, metrics."""
