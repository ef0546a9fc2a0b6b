"""The port's checkpoint format (counterpart of
sign_language_nlp_tpu/training/checkpoint.py).

`<workdir>/params.pt` holds the model's state dict (`torch.save`);
`<workdir>/params.json` is the descriptor, with the keys the JAX
pipeline writes (sign_language_nlp_tpu/pipeline.py:290-303): model,
best_params, model_args, compat_args, precision_args, src/tgt vocab
sizes and both vocabularies' itos. A JAX checkpoint becomes one of these
with scripts/jax_checkpoint_to_torch.py.
"""
from __future__ import annotations

import os

import torch

from ..utils import log, read_json, save_json


def save_checkpoint(workdir: str, state_dict: dict, descriptor: dict) -> str:
    """Write `<workdir>/params.pt` + `<workdir>/params.json`."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, "params.pt")
    torch.save({k: v.detach().cpu() for k, v in state_dict.items()}, path)
    save_json(descriptor, os.path.join(workdir, "params.json"))
    log(f"Checkpoint saved: {path} ({os.path.getsize(path) / 1e6:.2f} MB)")
    return path


def load_checkpoint(workdir: str) -> dict:
    """The state dict saved by `save_checkpoint`, on the CPU."""
    return torch.load(os.path.join(workdir, "params.pt"),
                      map_location="cpu", weights_only=True)


def load_descriptor(workdir: str) -> dict:
    return read_json(os.path.join(workdir, "params.json"))
