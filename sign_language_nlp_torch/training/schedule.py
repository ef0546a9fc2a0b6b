"""Per-cell monitor state: ReduceLROnPlateau + EarlyStopping + best
checkpoint, as array updates over the population (counterpart of
sign_language_nlp_tpu/training/schedule.py:45-126, in numpy on the
host: a few scalars a cell, read once an epoch).

  * ReduceLROnPlateau on valid_loss, torch semantics: rel-threshold
    improvement `metric < best*(1-threshold)`, `bad > patience` sets
    `lr *= factor` (floored at min_lr) and resets the counter;
  * EarlyStopping on valid_loss, skorch semantics: a miss is an epoch
    without improvement over the threshold; `misses == patience` stops;
  * Checkpoint(valid_loss_best): improvement with no threshold.

Every update is gated on `~stopped`: a stopped cell's state never
changes again, as if its fit had ended.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class PlateauConfig(NamedTuple):
    factor: float = 0.1
    patience: int = 10
    threshold: float = 1e-4
    threshold_mode: str = "rel"  # 'rel' | 'abs'
    min_lr: float = 0.0
    enabled: bool = True


class EarlyStopConfig(NamedTuple):
    patience: int = 5
    threshold: float = 1e-4
    threshold_mode: str = "rel"
    enabled: bool = True


class MonitorState(NamedTuple):
    lr: np.ndarray            # [P] f32 current learning rate
    plateau_best: np.ndarray  # [P] f32 best metric seen by the scheduler
    plateau_bad: np.ndarray   # [P] i32 epochs since scheduler improvement
    es_best: np.ndarray       # [P] f32 best metric seen by early stopping
    es_misses: np.ndarray     # [P] i32 consecutive non-improvements
    ckpt_best: np.ndarray     # [P] f32 best metric seen by the checkpoint
    stopped: np.ndarray       # [P] bool: the cell has early-stopped
    epoch: np.ndarray         # [P] i32 epochs run (freezes on stop)


def init_monitor_state(lr0) -> MonitorState:
    lr0 = np.array(lr0, np.float32, copy=True)
    p = lr0.shape
    return MonitorState(lr=lr0, plateau_best=np.full(p, np.inf, np.float32),
                        plateau_bad=np.zeros(p, np.int32),
                        es_best=np.full(p, np.inf, np.float32),
                        es_misses=np.zeros(p, np.int32),
                        ckpt_best=np.full(p, np.inf, np.float32),
                        stopped=np.zeros(p, bool),
                        epoch=np.zeros(p, np.int32))


def _improved(metric, best, threshold, mode: str):
    # In f32, as the JAX version computes it (a Python float meets an f32
    # array as f32 there).
    if mode == "rel":
        return metric < best * np.float32(1.0 - threshold)
    return metric < best - np.float32(threshold)


def update_monitor_state(state: MonitorState, valid_loss,
                         plateau: PlateauConfig,
                         early_stop: EarlyStopConfig):
    """One end-of-epoch update. Returns (new_state, ckpt_improved [P]
    bool)."""
    valid_loss = np.asarray(valid_loss, np.float32)
    live = ~state.stopped

    ckpt_improved = live & (valid_loss < state.ckpt_best)
    ckpt_best = np.where(ckpt_improved, valid_loss, state.ckpt_best)

    lr = state.lr
    plateau_best, plateau_bad = state.plateau_best, state.plateau_bad
    if plateau.enabled:
        imp = _improved(valid_loss, plateau_best, plateau.threshold,
                        plateau.threshold_mode)
        plateau_best = np.where(live & imp, valid_loss, plateau_best)
        plateau_bad = np.where(live, np.where(imp, 0, plateau_bad + 1),
                               plateau_bad).astype(np.int32)
        reduce = live & (plateau_bad > plateau.patience)
        lr = np.where(reduce, np.maximum(lr * np.float32(plateau.factor),
                                         np.float32(plateau.min_lr)),
                      lr).astype(np.float32)
        plateau_bad = np.where(reduce, 0, plateau_bad).astype(np.int32)

    es_best, es_misses, stopped = (state.es_best, state.es_misses,
                                   state.stopped)
    if early_stop.enabled:
        imp = _improved(valid_loss, es_best, early_stop.threshold,
                        early_stop.threshold_mode)
        es_best = np.where(live & imp, valid_loss, es_best)
        es_misses = np.where(live, np.where(imp, 0, es_misses + 1),
                             es_misses).astype(np.int32)
        stopped = stopped | (live & (es_misses >= early_stop.patience))

    epoch = np.where(live, state.epoch + 1, state.epoch).astype(np.int32)
    new_state = MonitorState(lr=lr, plateau_best=plateau_best,
                             plateau_bad=plateau_bad, es_best=es_best,
                             es_misses=es_misses, ckpt_best=ckpt_best,
                             stopped=stopped, epoch=epoch)
    return new_state, ckpt_improved
