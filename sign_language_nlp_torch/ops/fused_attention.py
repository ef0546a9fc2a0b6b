"""Fused multi-head attention forward: the CUDA kernel's wrapper and its
plain PyTorch version.

Counterpart of the TPU kernel K1's forward with dropout off
(sign_language_nlp_tpu/ops/pallas_attention_train.py:111-136, 203-217)
and of its model-layout wrapper `multi_head_attention_pallas`
(sign_language_nlp_tpu/ops/pallas_attention.py:108-129).

The kernel (csrc/fused_attention_fwd.cu) takes q [B,Sq,E] and k/v
[B,Sk,E] in model layout and a head-shared bias [B,Sq,Sk] f32, and reads
each head at column offset h*D, so no head split or merge copy touches
device memory. On the H100 it is bound by its f32 inner loops over
shared-memory K/V tiles, not by device-memory bytes: it streams each K/V
tile once per block of 32 query rows and never materialises the
[B,H,Sq,Sk] scores that the plain version writes and reads back. Its
design (one block per query tile, head and batch row; an online softmax
over key tiles; D as a template parameter) is in the source's header.
"""
from __future__ import annotations

import math

import torch

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)


def head_shared_bias(bias: torch.Tensor | None, B: int, Sq: int,
                     Sk: int, device: torch.device) -> torch.Tensor:
    """An additive bias broadcastable to [B, 1, Sq, Sk] (the framework's
    masks are per row, never per head) → contiguous [B, Sq, Sk] f32.
    `None` becomes zeros. A bias that is already that tensor comes back
    as it is, with no copy, so a caller can build it once per forward
    and share it across layers."""
    if bias is None:
        return torch.zeros((B, Sq, Sk), dtype=torch.float32, device=device)
    if bias.dim() == 4:
        if bias.shape[1] != 1:
            raise ValueError(f"bias {tuple(bias.shape)} is per head; the "
                             "fused kernel takes a head-shared bias")
        bias = bias[:, 0]
    return (bias.to(torch.float32).expand(B, Sq, Sk).contiguous())


def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the einsum path of
    sign_language_nlp_tpu/ops/attention.py:75-92 written with matmul and
    softmax. q [B,Sq,E], k/v [B,Sk,E], bias [B,Sq,Sk] → [B,Sq,E] in q's
    dtype; scores and softmax in f32."""
    B, Sq, E = q.shape
    Sk = k.shape[1]
    D = E // num_heads
    qh = q.reshape(B, Sq, num_heads, D).transpose(1, 2).float()
    kh = k.reshape(B, Sk, num_heads, D).transpose(1, 2).float()
    vh = v.reshape(B, Sk, num_heads, D).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    weights = torch.softmax(scores + bias[:, None].float(), dim=-1)
    out = torch.matmul(weights.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(B, Sq, E).to(q.dtype)


def _check_inputs(q, k, v, bias, num_heads) -> None:
    """What the kernel takes: f32, model layout, contiguous, one CUDA
    device. Dtype, shapes and layout are checked before the device, so
    each refusal can be shown without a card."""
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if t.dtype != torch.float32:
            raise TypeError(f"fused attention takes float32 {name}, got "
                            f"{t.dtype} (bf16 is queued in ROADMAP.md)")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [B,Sq,E], [B,Sk,E] x2")
    B, Sq, E = q.shape
    Sk = k.shape[1]
    if k.shape[0] != B or k.shape[2] != E:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tuple(bias.shape) != (B, Sq, Sk):
        raise ValueError(f"bias {tuple(bias.shape)}, expected "
                         f"{(B, Sq, Sk)}")
    if E % num_heads or E // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"E={E}, num_heads={num_heads}: head width must "
                         f"be one of {SUPPORTED_HEAD_DIMS}")
    if B == 0 or Sq == 0 or Sk == 0 or B > 65535 or num_heads > 65535:
        raise ValueError(f"B={B}, Sq={Sq}, Sk={Sk}, H={num_heads}: empty "
                         "or beyond the launch grid")
    for name, t in (("q", q), ("k", k), ("v", v), ("bias", bias)):
        if not t.is_contiguous():
            raise ValueError(f"fused attention takes contiguous {name}")
    if q.device.type != "cuda" or any(t.device != q.device
                                      for t in (k, v, bias)):
        raise ValueError("fused attention launches on one CUDA device; "
                         f"got q on {q.device}, k on {k.device}, v on "
                         f"{v.device}, bias on {bias.device}")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream. q [B,Sq,E], k/v
    [B,Sk,E], bias [B,Sq,Sk], all f32, contiguous and on one CUDA device.
    Adds one to `fused_attention_fwd.launches` per launch."""
    from ..kernels.build import fused_attention_library

    _check_inputs(q, k, v, bias, num_heads)
    lib = fused_attention_library()
    B, Sq, E = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, E), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slt_fused_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), B, Sq, Sk, E, num_heads,
            1.0 / math.sqrt(E // num_heads), stream)
    if rc != 0:
        raise RuntimeError("fused attention launch failed: "
                           f"{lib.slt_cuda_error_string(rc).decode()}")
    fused_attention_fwd.launches += 1
    return out


fused_attention_fwd.launches = 0

