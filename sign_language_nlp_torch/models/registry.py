"""Model registry: config name → model (counterpart of
sign_language_nlp_tpu/models/registry.py:14-90, with the same names and
the same filtering of `model_args` and `compat_args`).

Only the Transformer is ported; the GRU and LSTM names raise until
ROADMAP queue 1 item 10 brings them.
"""
from __future__ import annotations

import torch

from .transformer import Transformer

_TRANSFORMER_NAMES = {"model.Transformer", "Transformer", "transformer"}
_RECURRENT_NAMES = {"model.EncoderDecoderLSTMAttn", "EncoderDecoderLSTMAttn",
                    "lstm", "model.EncoderDecoderGRUAttn",
                    "EncoderDecoderGRUAttn", "gru"}
# Keys of `model_args` the Transformer understands; unknown keys are
# dropped (the reference forwards **model_args and its modules ignore
# extras).
_TRANSFORMER_KEYS = {"embedding_size", "hidden_size", "num_layers", "dropout",
                     "num_heads"}
# `scan_layers` is accepted for descriptor compatibility and ignored: it
# only changes the flax param tree, which models/convert.py unstacks.
_COMPAT_KEYS = ("causal_encoder", "mask_memory", "tgt_input", "attn_backend")


def build_model(name: str, src_vocab_size: int, tgt_vocab_size: int,
                src_pad_idx: int, tgt_pad_idx: int, bos_idx: int = 0,
                model_args: dict | None = None,
                compat_args: dict | None = None,
                precision_args: dict | None = None,
                generator: torch.Generator | None = None) -> Transformer:
    """Instantiate a model from config values, with weights drawn from
    `generator` (a fixed seed when None)."""
    if name in _RECURRENT_NAMES:
        raise NotImplementedError(
            f"{name}: the GRU/LSTM families are not ported yet (ROADMAP "
            "queue 1 item 10)")
    if name not in _TRANSFORMER_NAMES:
        known = sorted(_TRANSFORMER_NAMES | _RECURRENT_NAMES)
        raise ValueError(f"Unknown model: '{name}' (known: {known})")
    dtype_name = (precision_args or {}).get("compute_dtype")
    if dtype_name and dtype_name != "float32":
        raise NotImplementedError(
            f"compute_dtype {dtype_name!r}: the port runs float32 only; "
            "bf16 is queued in ROADMAP.md")
    kwargs = {k: v for k, v in (model_args or {}).items()
              if k in _TRANSFORMER_KEYS and v is not None}
    compat = {k: v for k, v in (compat_args or {}).items()
              if k in _COMPAT_KEYS}
    return Transformer(src_vocab_size=src_vocab_size,
                       tgt_vocab_size=tgt_vocab_size,
                       src_pad_idx=src_pad_idx, tgt_pad_idx=tgt_pad_idx,
                       bos_idx=bos_idx, generator=generator,
                       **kwargs, **compat)
