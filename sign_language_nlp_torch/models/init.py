"""Parameter initialisers matching the torch modules the reference
builds on (counterpart of sign_language_nlp_tpu/models/init.py:18-44),
drawn from an explicit `torch.Generator`:

  * torch Linear: weight & bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in))
  * torch nn.Transformer: Xavier-uniform on matrices, Linear-default
    on biases
  * torch Embedding: N(0, 1)
"""
from __future__ import annotations

import math

import torch
from torch import nn


@torch.no_grad()
def torch_linear_(layer: nn.Linear, generator: torch.Generator,
                  xavier: bool = False) -> nn.Linear:
    """Initialise `layer` in place like torch nn.Linear, or with a
    Xavier-uniform weight for transformer blocks."""
    fan_out, fan_in = layer.weight.shape
    k = 1.0 / math.sqrt(fan_in)
    w = math.sqrt(6.0 / (fan_in + fan_out)) if xavier else k
    layer.weight.uniform_(-w, w, generator=generator)
    if layer.bias is not None:
        layer.bias.uniform_(-k, k, generator=generator)
    return layer


@torch.no_grad()
def embedding_(layer: nn.Embedding,
               generator: torch.Generator) -> nn.Embedding:
    layer.weight.normal_(0.0, 1.0, generator=generator)
    return layer
