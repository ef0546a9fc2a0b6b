"""The port's data layer: ASL-Phono corpus building, composition
strategies, vocabularies and static-shape array datasets.

A copy of sign_language_nlp_tpu/data (tokens, vocab, compose, builder,
dataset), which holds only numpy and standard-library code; the copies
differ from it only in the C++ loader branch of builder.py, which is not
ported. tests/test_torch_data.py holds the two to the same vocabularies,
tokens, lengths and labels. `balance.py` comes with the grid driver.
"""
from .builder import DatasetBuilder
from .dataset import AslDataset
from .tokens import BOS_WORD, EOS_WORD, PAD_WORD, UNK_WORD
from .vocab import Vocab

__all__ = ["AslDataset", "BOS_WORD", "DatasetBuilder", "EOS_WORD",
           "PAD_WORD", "UNK_WORD", "Vocab"]
