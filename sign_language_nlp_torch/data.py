"""The data layer the port shares with the JAX package.

Corpus parsing, vocabularies and tokenized datasets hold no framework
code (sign_language_nlp_tpu/data/__init__.py:8-19 imports no jax, and
that package's top level imports its submodules lazily), so the port
imports them instead of keeping a copy that could drift from the
reference's tokenization. This module is the one place in the port
that names them; tests/test_torch_predict.py shows that the serving
path still imports no jax or flax.
"""
from sign_language_nlp_tpu.data.builder import DatasetBuilder
from sign_language_nlp_tpu.data.dataset import AslDataset
from sign_language_nlp_tpu.data.vocab import Vocab

__all__ = ["AslDataset", "DatasetBuilder", "Vocab"]
