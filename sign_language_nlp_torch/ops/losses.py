"""Loss functions with the reference's semantics (counterpart of
sign_language_nlp_tpu/ops/losses.py).

The reference configures `torch.nn.CrossEntropyLoss(ignore_index=pad)`
over model outputs that are already log-softmaxed, a double log-softmax
that the JAX package keeps (its ops/losses.py:1-12): the default
criterion is `nll(log_softmax(model_output), y)`. "nll" is the plain NLL
over the model's log-probs. Both take `ignore_index` and a per-row
`sample_weight`, with torch's mean reduction over the weighted rows.
"""
from __future__ import annotations

import torch


def nll_loss(log_probs: torch.Tensor, targets: torch.Tensor,
             ignore_index: int = -100,
             sample_weight: torch.Tensor | None = None) -> torch.Tensor:
    """Mean negative log-likelihood of `targets` under `log_probs`
    [.., V], skipping entries equal to `ignore_index` (torch NLLLoss
    mean-reduction semantics)."""
    valid = targets != ignore_index
    safe = torch.where(valid, targets, torch.zeros_like(targets)).long()
    picked = torch.gather(log_probs, -1, safe[..., None])[..., 0]
    w = valid.to(log_probs.dtype)
    if sample_weight is not None:
        w = w * sample_weight
    return -torch.sum(picked * w) / torch.clamp(torch.sum(w), min=1.0)


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       ignore_index: int = -100,
                       sample_weight: torch.Tensor | None = None
                       ) -> torch.Tensor:
    """torch.nn.CrossEntropyLoss: log_softmax then NLL. When `logits`
    are themselves log-probs this reproduces the reference's
    double-log-softmax quirk exactly."""
    return nll_loss(torch.log_softmax(logits, dim=-1), targets,
                    ignore_index=ignore_index, sample_weight=sample_weight)


_CRITERIA = {
    "torch.nn.CrossEntropyLoss": cross_entropy_loss,
    "CrossEntropyLoss": cross_entropy_loss,
    "cross_entropy": cross_entropy_loss,
    "torch.nn.NLLLoss": nll_loss,
    "NLLLoss": nll_loss,
    "nll": nll_loss,
}


def resolve_criterion(name: str):
    if name not in _CRITERIA:
        raise ValueError(f"Unknown criterion: '{name}' "
                         f"(known: {sorted(_CRITERIA)})")
    return _CRITERIA[name]
