"""Scaled-dot-product multi-head attention for the port.

Counterpart of sign_language_nlp_tpu/ops/attention.py. Two paths:

  * the fused CUDA kernels (ops/fused_attention.py), taken by backend
    "auto" and "pallas" for CUDA tensors: K1 alone at inference, K1 and
    K2 through an autograd function in training. The TPU package's
    "auto" conditions (ops/attention.py:55-59) are about the TPU and do
    not carry over; until the card's numbers set a policy, every CUDA
    attention goes to the kernels;
  * the plain version (the einsum path of ops/attention.py:75-92, with
    matmul and softmax), taken by backend "xla" on any device, and by
    every backend for CPU tensors.

Attention dropout takes per-row int32 seeds, drawn by the caller from
its generator on each call, as `_mha_pallas_train` draws them from the
layer's dropout key (ops/attention.py:111-112). Both paths drop the
same elements: the plain version takes the kernels' keep-mask from
`dropout_keep_mask`.

Masks are additive with the finite `NEG_INF`, so a row whose keys are
all masked averages V uniformly instead of turning into NaN.
"""
from __future__ import annotations

import torch

from .fused_attention import (dropout_keep_mask, fused_attention,
                              fused_attention_reference, head_shared_bias)

NEG_INF = -1e30  # finite mask value: keeps fully-masked rows NaN-free
BACKENDS = ("auto", "pallas", "xla")


def multi_head_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         bias: torch.Tensor | None = None, *,
                         num_heads: int, backend: str = "auto",
                         dropout_rate: float = 0.0,
                         seeds: torch.Tensor | None = None) -> torch.Tensor:
    """Attention over already-projected q [B,Sq,E] and k/v [B,Sk,E].
    `bias` is additive: broadcastable to [B,1,Sq,Sk], or already the
    kernel's contiguous [B,Sq,Sk] f32 (see `head_shared_bias`), which is
    used as it is. The plain version also takes a per-head bias
    broadcastable to [B,H,Sq,Sk], as the einsum path does; the kernels
    refuse one. With `dropout_rate` > 0, inverted dropout on the
    attention weights, keyed by int32 `seeds` [B]. Returns [B,Sq,E]."""
    if backend not in BACKENDS:
        raise ValueError(f"backend {backend!r} not in {BACKENDS}")
    if dropout_rate and seeds is None:
        raise ValueError("attention dropout needs per-row seeds [B]")
    if q.shape[-1] % num_heads:
        raise ValueError("embed dim must divide num_heads")
    B, Sq, _ = q.shape
    Sk = k.shape[1]
    if backend == "xla" or q.device.type == "cpu":
        per_head = bias is not None and bias.dim() == 4 and bias.shape[1] != 1
        keep = (dropout_keep_mask(seeds, num_heads, Sq, Sk, dropout_rate)
                if dropout_rate else None)
        return fused_attention_reference(
            q, k, v, bias if per_head else head_shared_bias(bias, B, Sq, Sk,
                                                            q.device),
            num_heads, keep, dropout_rate)
    return fused_attention(q, k, v, head_shared_bias(bias, B, Sq, Sk,
                                                     q.device),
                           num_heads, seeds, dropout_rate)


def causal_bias(seq_len: int, dtype=torch.float32,
                device=None) -> torch.Tensor:
    """[1, 1, S, S] additive causal bias (upper triangle masked)."""
    idx = torch.arange(seq_len, device=device)
    mask = idx[None, :] > idx[:, None]  # True above diagonal → masked
    return torch.where(mask, NEG_INF, 0.0).to(dtype)[None, None]


def padding_bias(valid: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """valid: [B, Sk] boolean (True = real token) → [B, 1, 1, Sk] bias."""
    return torch.where(valid, 0.0, NEG_INF).to(dtype)[:, None, None, :]
