"""Optimizers and gradient clipping for one cell (counterpart of
sign_language_nlp_tpu/training/optimizers.py:54-137).

The JAX package hand-rolls SGD and Adam/AdamW to carry a vector of
per-cell learning rates through one vmapped program. The port trains one
module per cell, so torch.optim's own SGD (momentum, nesterov, weight
decay, dampening 0), Adam and AdamW (decoupled decay, default 0.01) have
exactly those update rules; the cell's learning rate is set on the
optimizer before each epoch.
"""
from __future__ import annotations

import torch


def _canon(name: str) -> str:
    short = name.rsplit(".", 1)[-1].lower()
    if short in ("sgd", "adam", "adamw"):
        return short
    raise ValueError(f"Unknown optimizer: '{name}'")


def make_optimizer(name: str, optimizer_args: dict | None, params,
                   lr: float) -> torch.optim.Optimizer:
    """Config name (e.g. the reference's `torch.optim.SGD`) and args →
    a torch optimizer over `params` at learning rate `lr`."""
    args = dict(optimizer_args or {})
    kind = _canon(name)
    if kind == "sgd":
        momentum = float(args.get("momentum", 0.0))
        # nesterov with momentum 0 is plain SGD in the JAX rule; torch
        # refuses the combination.
        return torch.optim.SGD(
            params, lr=lr, momentum=momentum,
            nesterov=bool(args.get("nesterov", False)) and momentum > 0,
            weight_decay=float(args.get("weight_decay", 0.0)))
    betas = tuple(float(b) for b in args.get("betas", (0.9, 0.999)))
    common = {"lr": lr, "betas": betas, "eps": float(args.get("eps", 1e-8))}
    if kind == "adam":
        return torch.optim.Adam(
            params, weight_decay=float(args.get("weight_decay", 0.0)),
            **common)
    return torch.optim.AdamW(
        params, weight_decay=float(args.get("weight_decay", 0.01)), **common)


def set_lr(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = float(lr)


@torch.no_grad()
def clip_by_global_norm(grads: list, max_norm: float) -> torch.Tensor:
    """torch clip_grad_norm_'s rule, in place over one cell's gradients:
    scale = min(1, max_norm / (norm + 1e-6)). Returns the norm before
    clipping (a 0-d tensor on the gradients' device)."""
    total = torch.sqrt(sum(torch.sum(g.float() ** 2) for g in grads))
    scale = torch.clamp(max_norm / (total + 1e-6), max=1.0)
    for g in grads:
        g.mul_(scale.to(g.dtype))
    return total
