"""Cross-validation splitters with sklearn/skorch-exact semantics: the
port's copy of sign_language_nlp_tpu/search/kfold.py:16-67 (numpy only).

`GridSearchCV(cv=5)` over a classifier uses StratifiedKFold without
shuffling, and each skorch fit carves a stratified first-fold
train/valid split for its callbacks (skorch CVSplit(5, stratified=True)).
"""
from __future__ import annotations

import warnings

import numpy as np


def stratified_kfold(y: np.ndarray, n_splits: int) -> list:
    """sklearn StratifiedKFold(n_splits, shuffle=False) — returns
    [(train_idx, test_idx), ...] with identical fold assignment:
    per-class allocation from the sorted class-count distribution, folds
    assigned to each class's occurrences in order of appearance."""
    y = np.asarray(y)
    n = len(y)
    # sklearn encodes classes by order of FIRST APPEARANCE in y, not by
    # sorted value — fold allocation depends on this.
    _, y_first, y_inv = np.unique(y, return_index=True, return_inverse=True)
    _, class_perm = np.unique(y_first, return_inverse=True)
    y_encoded = class_perm[y_inv]
    n_classes = len(y_first)
    counts = np.bincount(y_encoded, minlength=n_classes)
    if n_splits > counts.min():
        warnings.warn(
            f"The least populated class has only {counts.min()} members, "
            f"fewer than n_splits={n_splits}.")

    y_order = np.sort(y_encoded)
    allocation = np.asarray([
        np.bincount(y_order[i::n_splits], minlength=n_classes)
        for i in range(n_splits)
    ])
    test_folds = np.empty(n, dtype=int)
    for k in range(n_classes):
        folds_for_class = np.arange(n_splits).repeat(allocation[:, k])
        test_folds[y_encoded == k] = folds_for_class

    splits = []
    for i in range(n_splits):
        test_idx = np.nonzero(test_folds == i)[0]
        train_idx = np.nonzero(test_folds != i)[0]
        splits.append((train_idx, test_idx))
    return splits


def train_valid_split(y: np.ndarray, n_splits: int = 5,
                      stratified: bool = True) -> tuple:
    """skorch CVSplit(n_splits, stratified) semantics: the FIRST fold of
    a (Stratified)KFold becomes the validation set, the rest train."""
    y = np.asarray(y)
    if stratified:
        train_idx, valid_idx = stratified_kfold(y, n_splits)[0]
    else:
        n = len(y)
        fold = n // n_splits + (1 if n % n_splits else 0)
        valid_idx = np.arange(fold)
        train_idx = np.arange(fold, n)
    return train_idx, valid_idx
