"""Scaled-dot-product multi-head attention for the port.

Counterpart of sign_language_nlp_tpu/ops/attention.py. Two paths:

  * the fused CUDA kernel (ops/fused_attention.py), taken by backend
    "auto" and "pallas" for CUDA tensors. The TPU package's "auto"
    conditions (ops/attention.py:55-59) are about the TPU and do not
    carry over; until the card's numbers set a policy, every CUDA
    attention goes to the kernel;
  * the plain version (the einsum path of ops/attention.py:75-92, with
    matmul and softmax), taken by backend "xla" on any device, and by
    every backend for CPU tensors.

Masks are additive with the finite `NEG_INF`, so a row whose keys are
all masked averages V uniformly instead of turning into NaN.
"""
from __future__ import annotations

import torch

from .fused_attention import (fused_attention_fwd, fused_attention_reference,
                              head_shared_bias)

NEG_INF = -1e30  # finite mask value: keeps fully-masked rows NaN-free
BACKENDS = ("auto", "pallas", "xla")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         num_heads: int, backend: str = "auto",
                         dropout_rate: float = 0.0) -> torch.Tensor:
    """Attention over already-projected q [B,Sq,E] and k/v [B,Sk,E].
    `bias` is additive and head-shared: either broadcastable to
    [B,1,Sq,Sk], or already the kernel's contiguous [B,Sq,Sk] f32 (see
    `head_shared_bias`), which is used as it is. Returns [B,Sq,E]. Attention dropout is not ported yet (ROADMAP queue 2, K1's
    dropout branch, with the training slice) and raises."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if dropout_rate:
        raise NotImplementedError(
            "attention dropout comes with the training slice (ROADMAP "
            "queue 2: K1's dropout branch and K2)")
    if q.shape[-1] % num_heads:
        raise ValueError("embed dim must divide num_heads")
    B, Sq, _ = q.shape
    bias_hs = head_shared_bias(bias, B, Sq, k.shape[1], q.device)
    if backend == "xla" or q.device.type == "cpu":
        return fused_attention_reference(q, k, v, bias_hs, num_heads)
    return fused_attention_fwd(q, k, v, bias_hs, num_heads)


def causal_bias(seq_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """[1, 1, S, S] additive causal bias (upper triangle masked)."""
    idx = torch.arange(seq_len, device=device)
    mask = idx[None, :] > idx[:, None]  # True above diagonal → masked
    return torch.where(mask, NEG_INF, 0.0).to(dtype)[None, None]


def padding_bias(valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """valid: [B, Sk] boolean (True = real token) → [B, 1, 1, Sk] bias."""
    return torch.where(valid, 0.0, NEG_INF).to(dtype)[:, None, None, :]
