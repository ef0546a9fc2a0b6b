"""Sinusoidal positional encoding (counterpart of
sign_language_nlp_tpu/models/positional.py:17-27):

    PE[pos, 2i]   = sin(pos / 10000^(2i/d))
    PE[pos, 2i+1] = cos(pos / 10000^(2i/d))

Computed in numpy exactly as the JAX package does, so both packages add
the same f32 table.
"""
from __future__ import annotations

import numpy as np
import torch


def sinusoidal_positional_encoding(seq_len: int, d_model: int,
                                   dtype=torch.float32,
                                   device=None) -> torch.Tensor:
    """[seq_len, d_model] table: even columns sin, odd columns cos,
    frequency exp(-(2i)·ln(10000)/d)."""
    position = np.arange(seq_len, dtype=np.float32)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float32)
                      * (-np.log(10000.0) / d_model))
    pe = np.zeros((seq_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term[: d_model // 2])
    return torch.from_numpy(pe).to(device=device, dtype=dtype)
