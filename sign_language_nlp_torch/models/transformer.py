"""Encoder-decoder Transformer sign classifier.

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
  * a log-softmax head on the decoder's single position, in f32;
  * in training mode, dropout at the JAX model's sites and rate
    (models/transformer.py:99-141, 216-239 there): both embedded streams,
    every residual branch before its add, the feed-forward's hidden
    activation, and the attention weights (through K1's dropout branch on
    the card). As in the JAX model, the rate is an argument of each call
    (`dropout_rate`, default the model's `dropout`), and so is the
    generator the masks are drawn from. `eval()` turns dropout off.

The population axis is not here: the port's trainer keeps one module per
cell (training/engine.py). `scan_layers` is not ported: layers are a
`ModuleList`, and models/convert.py unstacks a scanned flax tree.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.attention import causal_bias, multi_head_attention, padding_bias
from ..ops.dropout import dropout
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

    def forward(self, q_in, kv_in, bias, rate=0.0, generator=None):
        """`rate` > 0 drops attention weights, with per-row seeds drawn
        from `generator` on each call (callers pass 0 outside
        training)."""
        seeds = None
        if rate:
            seeds = torch.randint(0, torch.iinfo(torch.int32).max,
                                  (q_in.shape[0],), generator=generator,
                                  device=q_in.device, dtype=torch.int32)
        out = multi_head_attention(self.q_proj(q_in), self.k_proj(kv_in),
                                   self.v_proj(kv_in), bias,
                                   num_heads=self.num_heads,
                                   backend=self.backend, dropout_rate=rate,
                                   seeds=seeds)
        return self.out_proj(out)


class FeedForward(nn.Module):
    def __init__(self, d_model: int, hidden_size: int):
        super().__init__()
        self.linear1 = nn.Linear(d_model, hidden_size)
        self.linear2 = nn.Linear(hidden_size, d_model)

    def forward(self, x, rate=0.0, generator=None):
        h = dropout(torch.relu(self.linear1(x)), rate, generator)
        return self.linear2(h)


class EncoderLayer(nn.Module):
    def __init__(self, d_model: int, num_heads: int, hidden_size: int,
                 backend: str = "auto"):
        super().__init__()
        self.self_attn = MultiHeadAttentionBlock(d_model, num_heads, backend)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.ff = FeedForward(d_model, hidden_size)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, x, bias, rate=0.0, generator=None):
        def drop(t):
            return dropout(t, rate, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, bias, rate, generator)))
        return self.norm2(x + drop(self.ff(x, rate, generator)))


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

    def forward(self, x, memory, self_bias, cross_bias, rate=0.0,
                generator=None):
        def drop(t):
            return dropout(t, rate, generator)

        x = self.norm1(x + drop(self.self_attn(x, x, self_bias, rate,
                                               generator)))
        x = self.norm2(x + drop(self.cross_attn(x, memory, cross_bias, rate,
                                                generator)))
        return self.norm3(x + drop(self.ff(x, rate, generator)))


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
        self.dropout = dropout  # the training rate when a call passes None
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
                y: torch.Tensor | None = None,
                dropout_rate: float | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """tokens [B,S] int, lengths [B] (unused: padding is read from
        the pad index, as in the JAX model), y [B] labels → log-probs
        [B, V_tgt] f32. In training mode, dropout at `dropout_rate`
        (None: the model's `dropout`) with masks drawn from `generator`
        (None: torch's default generator)."""
        rate = 0.0
        if self.training:
            rate = float(self.dropout if dropout_rate is None
                         else dropout_rate)

        def drop(t):
            return dropout(t, rate, generator)

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
        src = drop(self.src_embedding(tokens.long()) * scale
                   + sinusoidal_positional_encoding(S, d, device=dev))
        tgt = drop(self.tgt_embedding(tgt_tokens) * scale
                   + sinusoidal_positional_encoding(1, d, device=dev))

        src_valid = tokens != self.src_pad_idx
        src_bias = padding_bias(src_valid)
        if self.causal_encoder:
            src_bias = src_bias + causal_bias(S, device=dev)
        tgt_bias = padding_bias(tgt_tokens != self.tgt_pad_idx)  # 1×1 causal ≡ 0
        cross_bias = padding_bias(src_valid) if self.mask_memory else None
        # Each bias becomes the kernel's contiguous [B,Sq,Sk] f32 once per
        # forward; every layer gets its [B,1,Sq,Sk] view, which the
        # kernel path takes with no copy.
        src_bias = head_shared_bias(src_bias, B, S, S, dev)[:, None]
        tgt_bias = head_shared_bias(tgt_bias, B, 1, 1, dev)[:, None]
        cross_bias = head_shared_bias(cross_bias, B, 1, S, dev)[:, None]

        h = src
        for layer in self.encoder_layers:
            h = layer(h, src_bias, rate, generator)
        memory = self.encoder_norm(h)

        g = tgt
        for layer in self.decoder_layers:
            g = layer(g, memory, tgt_bias, cross_bias, rate, generator)
        g = self.decoder_norm(g)

        logits = self.head(g[:, 0, :].float())
        return torch.log_softmax(logits, dim=-1)
