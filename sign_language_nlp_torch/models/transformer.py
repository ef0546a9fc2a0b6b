"""Encoder-decoder Transformer sign classifier, eval only.

Counterpart of sign_language_nlp_tpu/models/transformer.py:45-294, with
the same parameter names (a flax `encoder_layer_{i}` is the port's
`encoder_layers.{i}`), so models/convert.py maps one onto the other
name by name:

  * post-LayerNorm residual blocks (eps 1e-5), ReLU feed-forward, a
    final LayerNorm per stack;
  * embedding × sqrt(d) + sinusoidal PE on both streams;
  * the reference's quirk flags `causal_encoder` (causal mask on the
    encoder too), `mask_memory` (cross-attention masks padded memory
    only when True) and `tgt_input` ("label": the decoder reads the
    label; "bos": a constant token);
  * a log-softmax head on the decoder's single position, in f32.

Training (dropout, population axis) comes with the training slice
(ROADMAP queue 1 items 5-6); `scan_layers` is not ported: layers are a
`ModuleList`, and models/convert.py unstacks a scanned flax tree.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import causal_bias, multi_head_attention, padding_bias
from ..ops.fused_attention import head_shared_bias
from .init import embedding_, torch_linear_
from .positional import sinusoidal_positional_encoding


class MultiHeadAttentionBlock(nn.Module):
    """q/k/v projections + scaled-dot-product attention + output
    projection (torch MHA's fused qkv as three biased Linears)."""

    def __init__(self, d_model: int, num_heads: int,
                 backend: str = "auto"):
        super().__init__()
        self.num_heads = num_heads
        self.backend = backend
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.out_proj = nn.Linear(d_model, d_model)

    def forward(self, q_in, kv_in, bias):
        out = multi_head_attention(self.q_proj(q_in), self.k_proj(kv_in),
                                   self.v_proj(kv_in), bias,
                                   num_heads=self.num_heads,
                                   backend=self.backend)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_size: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, hidden_size)
        self.linear2 = nn.Linear(hidden_size, d_model)

    def forward(self, x):
        return self.linear2(torch.relu(self.linear1(x)))


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, hidden_size: int,
                 backend: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttentionBlock(d_model, num_heads, backend)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ff = FeedForward(d_model, hidden_size)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, bias):
        x = self.norm1(x + self.self_attn(x, x, bias))
        return self.norm2(x + self.ff(x))


class DecoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, hidden_size: int,
                 backend: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttentionBlock(d_model, num_heads, backend)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MultiHeadAttentionBlock(d_model, num_heads,
                                                  backend)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.ff = FeedForward(d_model, hidden_size)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, memory, self_bias, cross_bias):
        x = self.norm1(x + self.self_attn(x, x, self_bias))
        x = self.norm2(x + self.cross_attn(x, memory, cross_bias))
        return self.norm3(x + self.ff(x))


class Transformer(nn.Module):
    def __init__(self, src_vocab_size: int, tgt_vocab_size: int,
                 embedding_size: int = 512, num_heads: int = 8,
                 num_layers: int = 2, hidden_size: int = 512,
                 dropout: float = 0.1, src_pad_idx: int = 1,
                 tgt_pad_idx: int = 1, bos_idx: int = 0,
                 causal_encoder: bool = True, mask_memory: bool = False,
                 tgt_input: str = "label", attn_backend: str = "auto",
                 generator: torch.Generator | None = None):
        super().__init__()
        if tgt_input not in ("label", "bos"):
            raise ValueError(f"tgt_input {tgt_input!r} not in label/bos")
        d = embedding_size
        self.embedding_size = d
        self.dropout = dropout  # training rate, kept for the descriptor
        self.src_pad_idx, self.tgt_pad_idx = src_pad_idx, tgt_pad_idx
        self.bos_idx = bos_idx
        self.causal_encoder = causal_encoder
        self.mask_memory = mask_memory
        self.tgt_input = tgt_input
        self.src_embedding = nn.Embedding(src_vocab_size, d)
        self.tgt_embedding = nn.Embedding(tgt_vocab_size, d)
        self.encoder_layers = nn.ModuleList(
            EncoderLayer(d, num_heads, hidden_size, attn_backend)
            for _ in range(num_layers))
        self.encoder_norm = nn.LayerNorm(d, eps=1e-5)
        self.decoder_layers = nn.ModuleList(
            DecoderLayer(d, num_heads, hidden_size, attn_backend)
            for _ in range(num_layers))
        self.decoder_norm = nn.LayerNorm(d, eps=1e-5)
        self.head = nn.Linear(d, tgt_vocab_size)
        self.init_weights_(generator if generator is not None
                           else torch.Generator().manual_seed(0))

    def init_weights_(self, generator: torch.Generator) -> None:
        """The JAX package's init: Xavier-uniform weights in the
        attention and feed-forward blocks, torch-Linear init for the
        head and every bias, N(0,1) embeddings, LayerNorm ones/zeros."""
        embedding_(self.src_embedding, generator)
        embedding_(self.tgt_embedding, generator)
        for layer in (*self.encoder_layers, *self.decoder_layers):
            for m in layer.modules():
                if isinstance(m, nn.Linear):
                    torch_linear_(m, generator, xavier=True)
        torch_linear_(self.head, generator)

    def forward(self, tokens: torch.Tensor, lengths: torch.Tensor,
                y: torch.Tensor | None = None) -> torch.Tensor:
        """tokens [B,S] int, lengths [B] (unused: padding is read from
        the pad index, as in the JAX model), y [B] labels → log-probs
        [B, V_tgt] f32."""
        if self.training:
            raise NotImplementedError(
                "the port's Transformer is eval-only; training comes with "
                "ROADMAP queue 1 items 5-6 (call .eval())")
        B, S = tokens.shape
        d = self.embedding_size
        dev = tokens.device

        if self.tgt_input == "label":
            if y is None:
                raise ValueError("`y` is a required parameter")
            tgt_tokens = y.long()[:, None]
        else:
            tgt_tokens = torch.full((B, 1), self.bos_idx, dtype=torch.long,
                                    device=dev)

        scale = math.sqrt(d)
        src = (self.src_embedding(tokens.long()) * scale
               + sinusoidal_positional_encoding(S, d, device=dev))
        tgt = (self.tgt_embedding(tgt_tokens) * scale
               + sinusoidal_positional_encoding(1, d, device=dev))

        src_valid = tokens != self.src_pad_idx
        src_bias = padding_bias(src_valid)
        if self.causal_encoder:
            src_bias = src_bias + causal_bias(S, device=dev)
        tgt_bias = padding_bias(tgt_tokens != self.tgt_pad_idx)  # 1×1 causal ≡ 0
        cross_bias = padding_bias(src_valid) if self.mask_memory else None
        # Each bias becomes the kernel's [B,Sq,Sk] f32 once per forward;
        # every layer then uses it as it is.
        src_bias = head_shared_bias(src_bias, B, S, S, dev)
        tgt_bias = head_shared_bias(tgt_bias, B, 1, 1, dev)
        cross_bias = head_shared_bias(cross_bias, B, 1, S, dev)

        h = src
        for layer in self.encoder_layers:
            h = layer(h, src_bias)
        memory = self.encoder_norm(h)

        g = tgt
        for layer in self.decoder_layers:
            g = layer(g, memory, tgt_bias, cross_bias)
        g = self.decoder_norm(g)

        logits = self.head(g[:, 0, :].float())
        return torch.log_softmax(logits, dim=-1)
