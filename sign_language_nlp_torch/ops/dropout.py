"""Inverted dropout with an explicit generator (counterpart of
sign_language_nlp_tpu/ops/dropout.py:15-24).

The rate is an argument of each call, not of the module, as in the JAX
package, where cells that differ only in dropout share one program. The
port's population trains one module per cell, each with its own
`torch.Generator`, so a cell's draws do not depend on its neighbours.
"""
from __future__ import annotations

import torch


def dropout(x: torch.Tensor, rate: float,
            generator: torch.Generator | None,
            training: bool = True) -> torch.Tensor:
    """Keep each element with probability 1 - rate and scale it by
    1 / (1 - rate); everything is dropped at rate 1. Identity when not
    training or at rate 0 (where the JAX version keeps every element and
    scales by 1). `generator` None draws from torch's default one."""
    if not training or rate == 0.0:
        return x
    keep_prob = 1.0 - rate
    keep = torch.rand(x.shape, generator=generator, device=x.device,
                      dtype=torch.float32) < keep_prob
    scale = 1.0 / max(keep_prob, 1e-12) if keep_prob > 0 else 0.0
    return torch.where(keep, x * scale, torch.zeros_like(x))
