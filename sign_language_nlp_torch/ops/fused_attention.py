"""Fused multi-head attention, forward and backward: the CUDA kernels'
wrappers, their autograd function and their plain PyTorch versions.

Counterpart of the TPU kernels K1 (forward, with and without dropout,
sign_language_nlp_tpu/ops/pallas_attention_train.py:111-136, 203-217)
and K2 (backward, :139-182, 220-236, with the custom VJP at :239-268),
and of the model-layout wrapper `multi_head_attention_pallas`
(sign_language_nlp_tpu/ops/pallas_attention.py:108-129).

The kernels (csrc/fused_attention_fwd.cu, csrc/fused_attention_bwd.cu)
take q [B,Sq,E] and k/v [B,Sk,E] in model layout and a head-shared bias
[B,Sq,Sk] f32, and read each head at column offset h*D, so no head split
or merge copy touches device memory. On the H100 they are bound by their
f32 inner loops over shared-memory tiles, not by device-memory bytes:
they never materialise the [B,H,Sq,Sk] scores that the plain version
writes and reads back. Their designs are in the sources' headers.

Dropout. The TPU kernels draw the keep-mask from the TPU's generator
seeded per batch row; here it is a stateless hash of (seed_b, h, i, j)
(csrc/dropout_mask.cuh), so K2 replays exactly the forward's mask and
`dropout_keep_mask` gives the same bits in plain PyTorch. The bits
cannot equal the TPU's; the rule on them (keep iff the top 24 bits are
>= rate * 2^24) and the scale 1/max(1-rate, 1e-6) are the TPU kernel's.
"""
from __future__ import annotations

import math

import numpy as np
import torch

SUPPORTED_HEAD_DIMS = (16, 32, 64, 128, 256)
_M32 = 0xFFFFFFFF


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
                             "fused kernel takes a head-shared bias "
                             "(backend=\"xla\" takes a per-head one)")
        bias = bias[:, 0]
    return (bias.to(torch.float32).expand(B, Sq, Sk).contiguous())


# --- the dropout keep-mask ------------------------------------------------

def dropout_threshold(rate: float) -> int:
    """Keep iff the top 24 bits of the hash are >= this: rate · 2²⁴ in
    f32, truncated (pallas_attention_train.py:65)."""
    return int(np.float32(rate) * np.float32(16777216.0))


def dropout_inv(rate: float) -> float:
    """The kept probabilities' scale, 1 / max(1 - rate, 1e-6) in f32
    (pallas_attention_train.py:124)."""
    return float(np.float32(1.0) / np.maximum(
        np.float32(1.0) - np.float32(rate), np.float32(1e-6)))


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x · c) mod 2³² for x in [0, 2³²) held in int64: a 32×32-bit
    product overflows int64, so x is split into 16-bit halves."""
    lo, hi = x & 0xFFFF, x >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """csrc/dropout_mask.cuh:slt_mix32 on int64 tensors in [0, 2³²)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def dropout_keep_mask(seeds: torch.Tensor, num_heads: int, Sq: int, Sk: int,
                      rate: float) -> torch.Tensor:
    """The kernels' keep-mask [B, H, Sq, Sk] (bool) for per-row int32
    `seeds` [B], bit for bit, with torch integer ops on seeds' device."""
    dev = seeds.device
    seed = seeds.to(torch.int64).reshape(-1, 1, 1) & _M32
    h = torch.arange(num_heads, device=dev).reshape(1, -1, 1)
    i = torch.arange(Sq, device=dev).reshape(1, 1, -1)
    j = torch.arange(Sk, device=dev)
    row_key = _mix32(_mix32(_mix32(seed ^ 0x9E3779B9) ^ h) ^ i)
    bits = _mix32(row_key[..., None] ^ j)
    return (bits >> 8) >= dropout_threshold(rate)


# --- the plain version ------------------------------------------------------

def fused_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, bias: torch.Tensor,
                              num_heads: int,
                              keep: torch.Tensor | None = None,
                              rate: float = 0.0) -> torch.Tensor:
    """Plain PyTorch version of the kernels: the einsum path of
    sign_language_nlp_tpu/ops/attention.py:75-92 written with matmul and
    softmax, with the kernels' dropout when `keep` ([B,H,Sq,Sk] bool,
    from `dropout_keep_mask`) is given. q [B,Sq,E], k/v [B,Sk,E], bias
    head-shared [B,Sq,Sk] or 4-D broadcastable to [B,H,Sq,Sk] (a per-head
    bias, which the einsum path takes and the kernels do not) → [B,Sq,E]
    in q's dtype; scores and softmax in f32. Its backward is PyTorch
    autograd."""
    B, Sq, E = q.shape
    Sk = k.shape[1]
    D = E // num_heads
    qh = q.reshape(B, Sq, num_heads, D).transpose(1, 2).float()
    kh = k.reshape(B, Sk, num_heads, D).transpose(1, 2).float()
    vh = v.reshape(B, Sk, num_heads, D).transpose(1, 2)
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * (1.0 / math.sqrt(D))
    bias = bias[:, None] if bias.dim() == 3 else bias
    weights = torch.softmax(scores + bias.float(), dim=-1)
    if keep is not None:
        weights = torch.where(keep, weights * dropout_inv(rate), 0.0)
    out = torch.matmul(weights.to(vh.dtype), vh)
    return out.transpose(1, 2).reshape(B, Sq, E).to(q.dtype)


# --- the kernels' wrappers ----------------------------------------------------

def _check_inputs(q, k, v, bias, num_heads, seeds=None, rate=0.0,
                  more=()) -> None:
    """What the kernels take: f32, model layout, contiguous, one CUDA
    device; int32 seeds [B] when rate > 0. Dtype, shapes and layout are
    checked before the device, so each refusal can be shown without a
    card. `more` holds further f32 tensors of q's or k's shape."""
    named = (("q", q), ("k", k), ("v", v), ("bias", bias), *more)
    for name, t in named:
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
    for name, t in more:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)}, expected "
                             f"{tuple(q.shape)}")
    if E % num_heads or E // num_heads not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"E={E}, num_heads={num_heads}: head width must "
                         f"be one of {SUPPORTED_HEAD_DIMS}")
    if B == 0 or Sq == 0 or Sk == 0 or B > 65535 or num_heads > 65535:
        raise ValueError(f"B={B}, Sq={Sq}, Sk={Sk}, H={num_heads}: empty "
                         "or beyond the launch grid")
    if not 0.0 <= rate <= 1.0:
        raise ValueError(f"dropout rate {rate} outside [0, 1]")
    tensors = [t for _, t in named]
    if rate > 0.0:
        if (seeds is None or seeds.dtype != torch.int32
                or tuple(seeds.shape) != (B,)):
            raise ValueError("dropout takes int32 seeds [B], one per "
                             "batch row")
        tensors.append(seeds)
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"fused attention takes contiguous {name}")
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError("fused attention launches on one CUDA device; "
                         f"got q on {q.device}, k on {k.device}, v on "
                         f"{v.device}, bias on {bias.device}")


def _raise_on(lib, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: "
                           f"{lib.slt_cuda_error_string(rc).decode()}")


def fused_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, num_heads: int,
                        seeds: torch.Tensor | None = None,
                        rate: float = 0.0, return_stats: bool = False):
    """Launch K1 on the current stream. q [B,Sq,E], k/v [B,Sk,E], bias
    [B,Sq,Sk], all f32, contiguous and on one CUDA device; with rate > 0
    the dropout branch, with int32 `seeds` [B]. Returns out [B,Sq,E],
    and with `return_stats` also the softmax statistics [B,H,Sq,2] (row
    max, row sum) that K2 takes. Adds one to
    `fused_attention_fwd.launches` per launch, and to
    `fused_attention_fwd.dropout_launches` when the dropout branch
    ran."""
    from ..kernels.build import fused_attention_library

    rate = float(rate)
    _check_inputs(q, k, v, bias, num_heads, seeds, rate)
    lib = fused_attention_library()
    B, Sq, E = q.shape
    Sk = k.shape[1]
    out = torch.empty((B, Sq, E), dtype=q.dtype, device=q.device)
    stats = (torch.empty((B, num_heads, Sq, 2), dtype=torch.float32,
                         device=q.device) if return_stats else None)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slt_fused_attention_fwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), None if stats is None else stats.data_ptr(),
            seeds.data_ptr() if rate > 0.0 else None, rate,
            B, Sq, Sk, E, num_heads, 1.0 / math.sqrt(E // num_heads),
            stream)
    _raise_on(lib, rc, "fused attention forward")
    fused_attention_fwd.launches += 1
    if rate > 0.0:
        fused_attention_fwd.dropout_launches += 1
    return (out, stats) if return_stats else out


fused_attention_fwd.launches = 0
fused_attention_fwd.dropout_launches = 0


def fused_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: torch.Tensor, dout: torch.Tensor,
                        stats: torch.Tensor, num_heads: int,
                        seeds: torch.Tensor | None = None,
                        rate: float = 0.0):
    """Launch K2 on the current stream: (dq, dk, dv) of K1's output for
    the incoming gradient `dout`, with K1's `stats` and the same seeds
    and rate. Adds one to `fused_attention_bwd.launches` per launch."""
    from ..kernels.build import fused_attention_bwd_library

    rate = float(rate)
    _check_inputs(q, k, v, bias, num_heads, seeds, rate,
                  more=(("dout", dout),))
    B, Sq, E = q.shape
    Sk = k.shape[1]
    if (stats.dtype != torch.float32 or not stats.is_contiguous()
            or tuple(stats.shape) != (B, num_heads, Sq, 2)
            or stats.device != q.device):
        raise ValueError("stats must be K1's contiguous f32 "
                         f"[{B},{num_heads},{Sq},2] on {q.device}")
    lib = fused_attention_bwd_library()
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty((B, num_heads, Sq), dtype=torch.float32,
                        device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slt_fused_attention_bwd_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            dout.data_ptr(), stats.data_ptr(),
            seeds.data_ptr() if rate > 0.0 else None, rate,
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), delta.data_ptr(),
            B, Sq, Sk, E, num_heads, 1.0 / math.sqrt(E // num_heads),
            stream)
    _raise_on(lib, rc, "fused attention backward")
    fused_attention_bwd.launches += 1
    return dq, dk, dv


fused_attention_bwd.launches = 0


class FusedAttention(torch.autograd.Function):
    """K1 forward, K2 backward. The bias (a mask constant), the seeds and
    the rate get no gradient, as in the TPU kernel's VJP
    (pallas_attention_train.py:257-265)."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seeds, rate, num_heads):
        out, stats = fused_attention_fwd(q, k, v, bias, num_heads, seeds,
                                         rate, return_stats=True)
        ctx.save_for_backward(q, k, v, bias, stats, seeds)
        ctx.rate, ctx.num_heads = rate, num_heads
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, bias, stats, seeds = ctx.saved_tensors
        dq, dk, dv = fused_attention_bwd(q, k, v, bias, dout.contiguous(),
                                         stats, ctx.num_heads, seeds,
                                         ctx.rate)
        return dq, dk, dv, None, None, None, None


def fused_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: torch.Tensor, num_heads: int,
                    seeds: torch.Tensor | None = None,
                    rate: float = 0.0) -> torch.Tensor:
    """Attention through the kernels: the autograd function when a
    gradient is wanted, else K1 alone (no statistics kept)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FusedAttention.apply(q, k, v, bias, seeds, float(rate),
                                    num_heads)
    return fused_attention_fwd(q, k, v, bias, num_heads, seeds, rate)
