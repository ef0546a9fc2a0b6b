"""sign_language_nlp_torch — the PyTorch/CUDA port of sign_language_nlp_tpu.

A second package beside the JAX one, for an NVIDIA H100. The JAX package
is the reference: each slice of the port is held against it on the same
inputs and weights (tests/test_torch_*.py). Every TPU kernel on a ported
path is rewritten by hand for Hopper (csrc/), with a plain PyTorch version
beside it. The port imports nothing of the JAX package: what it needs of
the framework-free layers (data, utils, the k-fold splitter) it keeps as
its own copies (tests/test_torch_isolation.py shows it).

Ported so far: the transformer serving path,
``python -m sign_language_nlp_torch.predict``, and the population
trainer, ``training.engine.PopulationTrainer.fit``, with the fused
attention forward (with and without dropout) and backward as CUDA
kernels; and the single-head fused attention op,
``ops.fused_attention_bh.fused_attention_bh`` over [BH,S,D] slices with
a per-slice bias, whose forward is a CUDA kernel and whose gradient
(the bias's included) is autograd of its plain version. With it every
TPU kernel of the JAX package has its CUDA counterpart.

Layout:
  data/      — corpus building, vocabularies, static-shape datasets
  utils/     — logging and filesystem helpers
  ops/       — attention dispatch; the fused kernels' wrappers, autograd
               functions and plain versions; the single-head op
               (fused_attention_bh); dropout, losses, metrics
  csrc/      — hand-written CUDA C++ for sm_90a
  kernels/   — nvcc build at first use, ctypes binding
  models/    — Transformer, initialisers, registry, flax→torch weight
               conversion
  training/  — the population trainer, optimizers, monitor (plateau,
               early stopping, best params), checkpoint format
  search/    — the stratified k-fold and monitor splits
  predict.py — the serving CLI

Importing the package imports nothing heavy; this module is docs only.
"""

__version__ = "0.2.0"
