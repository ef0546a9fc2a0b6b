"""Single-head fused attention over head-split slices: the CUDA kernel
K3's wrapper, its autograd function, its plain PyTorch version and the
op's entry point.

Counterpart of sign_language_nlp_tpu/ops/pallas_attention.py:20-105:
the TPU kernel `_attention_kernel` (:36), reached through
`_pallas_attention_fwd_impl` (:55) and the public `fused_attention`
(:88-105), whose gradient is autodiff of `_xla_reference` (:78-85)
through `jax.custom_vjp`. The name `fused_attention` is K1's in the port
(ops/fused_attention.py), so this op carries the `_bh` suffix.

q is [BH,Sq,D], k/v [BH,Sk,D], and the additive bias [BH,Sq,Sk] is each
slice's own. The kernel (csrc/fused_attention_bh.cu) takes f32 and any
head width D <= 256; its design is in the source's header. No path of
the model goes here: as in the JAX package, a transformer's attention
goes to K1 and K2 (ops/attention.py).
"""
from __future__ import annotations

import torch

MAX_HEAD_DIM = 256
_BQ = 32  # query rows per block of the kernel; the tiles are grid y


def fused_attention_bh_reference(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor,
                                 bias: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K3, as `_xla_reference`: scores and
    softmax in f32, the probabilities cast to v's dtype, the output in
    q's dtype. Its backward is PyTorch autograd."""
    scale = 1.0 / (q.shape[-1] ** 0.5)
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(scores + bias, dim=-1)
    return torch.matmul(probs.to(v.dtype).float(), v.float()).to(q.dtype)


def _check_inputs(q, k, v, bias) -> None:
    """What K3 takes: f32, [BH,Sq,D], [BH,Sk,D] x2, [BH,Sq,Sk], D <= 256,
    contiguous, one CUDA device. Dtype, shapes and layout are checked
    before the device, so each refusal can be shown without a card."""
    named = (("q", q), ("k", k), ("v", v), ("bias", bias))
    for name, t in named:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_attention_bh takes float32 {name}, got "
                            f"{t.dtype} (bf16 is ROADMAP.md queue 1 item "
                            "14)")
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}: expected [BH,Sq,D], [BH,Sk,D] "
                         "x2")
    BH, Sq, D = q.shape
    Sk = k.shape[1]
    if k.shape[0] != BH or k.shape[2] != D:
        raise ValueError(f"k/v {tuple(k.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if tuple(bias.shape) != (BH, Sq, Sk):
        raise ValueError(f"bias {tuple(bias.shape)}, expected "
                         f"{(BH, Sq, Sk)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"head width D={D}: the kernel takes D <= "
                         f"{MAX_HEAD_DIM}")
    if (BH == 0 or Sq == 0 or Sk == 0 or D == 0 or BH > 2 ** 31 - 1
            or -(-Sq // _BQ) > 65535):
        raise ValueError(f"BH={BH}, Sq={Sq}, Sk={Sk}, D={D}: empty or "
                         "beyond the launch grid")
    for name, t in named:
        if not t.is_contiguous():
            raise ValueError(f"fused_attention_bh takes contiguous {name}")
    if q.device.type != "cuda" or any(t.device != q.device for _, t in named):
        raise ValueError("fused_attention_bh launches on one CUDA device; "
                         f"got q on {q.device}, k on {k.device}, v on "
                         f"{v.device}, bias on {bias.device}")


def fused_attention_bh_fwd(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the current stream: q [BH,Sq,D], k/v [BH,Sk,D], bias
    [BH,Sq,Sk], all f32, contiguous and on one CUDA device → out
    [BH,Sq,D]. Adds one to `fused_attention_bh_fwd.launches` per
    launch."""
    from ..kernels.build import fused_attention_bh_library

    _check_inputs(q, k, v, bias)
    lib = fused_attention_bh_library()
    BH, Sq, D = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.slt_fused_attention_bh_f32(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            out.data_ptr(), BH, Sq, k.shape[1], D, 1.0 / (D ** 0.5), stream)
    if rc != 0:
        raise RuntimeError("fused_attention_bh launch failed: "
                           f"{lib.slt_cuda_error_string(rc).decode()}")
    fused_attention_bh_fwd.launches += 1
    return out


fused_attention_bh_fwd.launches = 0


class FusedAttentionBH(torch.autograd.Function):
    """K3 forward; the backward of `_bwd` (pallas_attention.py:99-102):
    autograd of the plain version, recomputed from the saved inputs.
    The bias gets a gradient when it needs one, as in the JAX VJP."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return fused_attention_bh_fwd(q, k, v, bias)

    @staticmethod
    def backward(ctx, g):
        needs = ctx.needs_input_grad
        with torch.enable_grad():
            inputs = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, needs)]
            out = fused_attention_bh_reference(*inputs)
            grads = iter(torch.autograd.grad(
                out, [t for t in inputs if t.requires_grad], g))
        return tuple(next(grads) if n else None for n in needs)


def fused_attention_bh(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       bias: torch.Tensor) -> torch.Tensor:
    """softmax(q kᵀ/√D + bias) v over each of the BH slices, the port of
    the JAX package's `fused_attention` (pallas_attention.py:88). CPU
    tensors take the plain version; CUDA tensors take the autograd
    function when a gradient is wanted, else K3 alone."""
    if q.device.type == "cpu":
        return fused_attention_bh_reference(q, k, v, bias)
    if torch.is_grad_enabled() and any(t.requires_grad
                                       for t in (q, k, v, bias)):
        return FusedAttentionBH.apply(q, k, v, bias)
    return fused_attention_bh_fwd(q, k, v, bias)
