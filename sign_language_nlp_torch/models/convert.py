"""Carry a flax Transformer's weights into the port's state dict.

`params_from_jax` takes the JAX package's param tree as nested dicts of
numpy arrays (what `flax.serialization.msgpack_restore` returns), so
the port itself never imports jax or flax. It handles:

  * Dense `kernel` [in, out] → Linear `weight` [out, in];
  * LayerNorm `scale` → `weight`, Embed `embedding` → `weight`;
  * a leading population axis [P, ...]: `params_from_jax_population`
    gives one state dict per cell (the JAX trainer's stacked params);
    `params_from_jax` takes a single cell, with or without an axis of
    size 1, as in the checkpoints the JAX pipeline writes
    (sign_language_nlp_tpu/predict.py:49-52);
  * a `scan_layers` tree (`encoder_layers/layer/...` stacked [L, ...]),
    unstacked into one entry per layer;
  * flax's `encoder_layer_{i}` naming, which becomes `encoder_layers.{i}`.
"""
from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

_LEAF_NAMES = {"kernel": "weight", "scale": "weight", "embedding": "weight",
               "bias": "bias"}
_UNROLLED = re.compile(r"^(encoder|decoder)_layer_(\d+)$")
_SCANNED = re.compile(r"^(encoder|decoder)_layers$")


def _flatten(tree: Mapping, prefix=()) -> dict:
    out = {}
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            out.update(_flatten(value, path))
        else:
            out[path] = np.asarray(value)
    return out


def _leaf(path: tuple, array: np.ndarray) -> tuple[str, torch.Tensor]:
    name = _LEAF_NAMES.get(path[-1])
    if name is None:
        raise ValueError(f"unexpected flax leaf {'/'.join(path)}")
    if path[-1] == "kernel":
        array = array.T
    return ".".join((*path[:-1], name)), torch.from_numpy(
        np.array(array, dtype=np.float32, order="C", copy=True))


def params_from_jax_population(tree: Mapping
                               ) -> list[dict[str, torch.Tensor]]:
    """Population-stacked flax Transformer params ([P, ...] leaves,
    optionally under a top-level "params" key, unrolled or scanned
    layers) → one state dict of the port's Transformer per cell."""
    if "params" in tree:
        tree = tree["params"]
    flat = _flatten(tree)
    if flat[("src_embedding", "embedding")].ndim != 3:
        raise ValueError("no population axis: use params_from_jax")
    sizes = {a.shape[0] for a in flat.values()}
    if len(sizes) != 1:
        raise ValueError(f"population axes of sizes {sorted(sizes)}")
    return [_state_dict({p: a[c] for p, a in flat.items()})
            for c in range(sizes.pop())]


def params_from_jax(tree: Mapping) -> dict[str, torch.Tensor]:
    """Flax Transformer params of one cell (optionally under a top-level
    "params" key, with or without a leading population axis of size 1,
    unrolled or scanned layers) → the port Transformer's state dict."""
    if "params" in tree:
        tree = tree["params"]
    flat = _flatten(tree)
    if flat[("src_embedding", "embedding")].ndim == 3:  # population axis
        cells = params_from_jax_population(tree)
        if len(cells) != 1:
            raise ValueError(f"population of {len(cells)} cells; use "
                             "params_from_jax_population")
        return cells[0]
    return _state_dict(flat)


def _state_dict(flat: dict) -> dict[str, torch.Tensor]:
    state = {}
    for path, array in flat.items():
        head = path[0]
        unrolled = _UNROLLED.match(head)
        if unrolled:
            path = (f"{unrolled[1]}_layers", unrolled[2]) + path[1:]
        elif _SCANNED.match(head):
            if path[1] != "layer":
                raise ValueError(f"unexpected scanned path {'/'.join(path)}")
            for i, layer_array in enumerate(array):
                key, t = _leaf((head, str(i)) + path[2:], layer_array)
                state[key] = t
            continue
        key, t = _leaf(path, array)
        state[key] = t
    return state
