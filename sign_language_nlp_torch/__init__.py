"""sign_language_nlp_torch — the PyTorch/CUDA port of sign_language_nlp_tpu.

A second package beside the JAX one, for an NVIDIA H100. The JAX package
is the reference: each slice of the port is held against it on the same
inputs and weights (tests/test_torch_*.py). Every TPU kernel on a ported
path is rewritten by hand for Hopper (csrc/), with a plain PyTorch version
beside it.

Ported so far: the transformer serving path,
``python -m sign_language_nlp_torch.predict``, with the fused attention
forward as a CUDA kernel. The framework-free layers (data, utils) are
imported from sign_language_nlp_tpu, whose data and utils modules import
no jax.

Layout:
  data.py    — the data layer shared with the JAX package
  ops/       — attention dispatch; the fused kernel's wrapper and its
               plain version
  csrc/      — hand-written CUDA C++ for sm_90a
  kernels/   — nvcc build at first use, ctypes binding
  models/    — Transformer (eval), initialisers, registry, flax→torch
               weight conversion
  training/  — checkpoint format (params.pt + params.json)
  predict.py — the serving CLI

Importing the package imports nothing heavy; this module is docs only.
"""

__version__ = "0.1.0"
