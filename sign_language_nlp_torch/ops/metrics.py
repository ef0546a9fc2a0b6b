"""The epoch loop's streaming metric statistics (counterpart of
sign_language_nlp_tpu/ops/metrics.py:120-183).

Each batch adds to per-class weighted counts and running sums, and the
five scorers of the reference (accuracy, precision/recall/f1 weighted
with zero_division=0, neg_log_loss over the full label set) and the
mean loss finalize from them, with sklearn's semantics. Weight-0 rows
(padding) count for nothing. The statistics stay on the device of the
model's outputs; only `finalize_metric_stats` reads them back.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

SCORERS = ("accuracy", "precision_weighted", "recall_weighted",
           "f1_weighted", "neg_log_loss")


def init_metric_stats(num_classes: int, device=None) -> dict:
    def zeros(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return {"tp": zeros(num_classes), "pred": zeros(num_classes),
            "actual": zeros(num_classes), "nll_sum": zeros(),
            "correct": zeros(), "weight": zeros(), "loss_sum": zeros()}


@torch.no_grad()
def update_metric_stats(stats: dict, y_true: torch.Tensor,
                        log_probs: torch.Tensor, sample_weight: torch.Tensor,
                        loss_sum: torch.Tensor | float | None = None
                        ) -> dict:
    """Accumulate one batch. `log_probs` [B,V] is the model output;
    predicted class = argmax; probabilities = softmax(log_probs) (the
    skorch predict_nonlinearity='auto' + CrossEntropyLoss convention the
    reference inherits), clipped to [eps, 1-eps] and renormalised for
    neg_log_loss as sklearn's log_loss does."""
    num_classes = log_probs.shape[-1]
    log_probs = log_probs.float()
    w = sample_weight.float()
    y_true = y_true.long()
    y_pred = torch.argmax(log_probs, dim=-1)
    t = F.one_hot(y_true, num_classes).float()
    p = F.one_hot(y_pred, num_classes).float()
    wcol = w[:, None]

    probs = torch.softmax(log_probs, dim=-1)
    eps = torch.finfo(torch.float32).eps
    pc = torch.clamp(probs, eps, 1.0 - eps)
    pc = pc / torch.sum(pc, dim=-1, keepdim=True)
    picked = torch.gather(pc, -1, y_true[:, None])[:, 0]

    return {
        "tp": stats["tp"] + torch.sum(t * p * wcol, dim=0),
        "pred": stats["pred"] + torch.sum(p * wcol, dim=0),
        "actual": stats["actual"] + torch.sum(t * wcol, dim=0),
        "nll_sum": stats["nll_sum"] - torch.sum(torch.log(picked) * w),
        "correct": stats["correct"]
        + torch.sum((y_true == y_pred).float() * w),
        "weight": stats["weight"] + torch.sum(w),
        "loss_sum": stats["loss_sum"] + (0.0 if loss_sum is None
                                         else loss_sum),
    }


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with 0 where den == 0: sklearn's zero_division=0."""
    return torch.where(den > 0, num / torch.clamp(den, min=1e-38),
                       torch.zeros_like(num))


def finalize_metric_stats(stats: dict, names) -> dict:
    """Sufficient statistics → {metric name: float} for the scorers and
    "loss" (the weighted mean of the batch losses)."""
    tp, pred, actual = stats["tp"], stats["pred"], stats["actual"]
    total = torch.clamp(stats["weight"], min=1e-38)
    support = torch.clamp(torch.sum(actual), min=1e-38)
    prec = _safe_div(tp, pred)
    rec = _safe_div(tp, actual)
    f1 = _safe_div(2.0 * prec * rec, prec + rec)
    all_values = {
        "accuracy": lambda: stats["correct"] / total,
        "precision_weighted": lambda: torch.sum(prec * actual) / support,
        "recall_weighted": lambda: torch.sum(rec * actual) / support,
        "f1_weighted": lambda: torch.sum(f1 * actual) / support,
        "neg_log_loss": lambda: -stats["nll_sum"] / total,
        "loss": lambda: stats["loss_sum"] / total,
    }
    unknown = set(names) - set(all_values)
    if unknown:
        raise ValueError(f"Unknown scoring metric(s) {sorted(unknown)} "
                         f"(known: {sorted(SCORERS)})")
    return {n: float(all_values[n]()) for n in names}
