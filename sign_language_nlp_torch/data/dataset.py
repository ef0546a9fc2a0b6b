"""Static-shape array dataset for the ASL-Phono corpus.

TPU-native replacement for the reference's `AslDataset`
(reference dataset/asl_dataset.py:9-303). The reference stores per-row
(tensor, length) tuples and re-materializes them through
torchtext/skorch adapters; here the whole corpus is three NumPy arrays —
`tokens` int32 [N, S], `lengths` int32 [N], `labels_idx` int32 [N] —
padded once to a single static sequence length (a multiple of
`pad_multiple` for friendly XLA tiling). Everything downstream (folds,
balancing, population training) is pure integer indexing into these
arrays, which is exactly what a sharded gather wants.

API parity with the reference facade:
  .stoi()            — numericalize (asl_dataset.py:204-208)
  .X() / .y()        — slice views with .to_array()
                       (asl_dataset.py:117-121, 288-303)
  .labels(fmt)       — all vocab entries incl. specials
                       (asl_dataset.py:210-213 quirk preserved)
  .truncated(n)      — head slice (asl_dataset.py:215-218)
  .split(lengths, seed) — seeded random split, [test, train] order
                       (asl_dataset.py:220-253)
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .builder import DatasetBuilder
from .vocab import Vocab


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


class ArrayView:
    """A `.to_array()`-style view over one column of the dataset
    (plays the role of reference `AslSliceDataset`,
    asl_dataset.py:256-303)."""

    def __init__(self, array: np.ndarray, lengths: np.ndarray | None = None):
        self._array = array
        self.lengths = lengths

    def to_array(self) -> np.ndarray:
        return self._array

    def __len__(self) -> int:
        return len(self._array)

    def __getitem__(self, idx):
        return self._array[idx]

    @property
    def shape(self):
        return self._array.shape


class AslDataset:
    def __init__(self,
                 tokens: np.ndarray,
                 lengths: np.ndarray,
                 labels_idx: np.ndarray,
                 src_vocab: Vocab,
                 tgt_vocab: Vocab,
                 batch_first: bool = True,
                 raw_src: Sequence[Sequence[str]] | None = None,
                 raw_tgt: Sequence[str] | None = None):
        assert tokens.ndim == 2 and lengths.ndim == 1 and labels_idx.ndim == 1
        assert len(tokens) == len(lengths) == len(labels_idx)
        self.tokens = np.asarray(tokens, dtype=np.int32)
        self.lengths = np.asarray(lengths, dtype=np.int32)
        self.labels_idx = np.asarray(labels_idx, dtype=np.int32)
        self.src_vocab = src_vocab
        self.tgt_vocab = tgt_vocab
        self.batch_first = batch_first
        self.raw_src = raw_src
        self.raw_tgt = raw_tgt

    # ---------------------------------------------------------------- build
    @classmethod
    def build(cls, dataset_args: dict, batch_first: bool = True,
              pad_multiple: int = 8, **kwargs) -> "AslDataset":
        """Fresh build from an ASL-Phono directory (reference
        asl_dataset.py:66-71 construction mode)."""
        known = {"dataset_dir", "fields", "samples_min_freq",
                 "composition_strategy", "reuse_transient", "use_native"}
        builder_args = {k: v for k, v in dataset_args.items() if k in known}
        built = DatasetBuilder().build(batch_first=batch_first,
                                       **builder_args)
        return cls.from_sequences(
            src=built["src"],
            tgt=[t[0] if t else "" for t in built["tgt"]],
            src_vocab=built["src_vocab"],
            tgt_vocab=built["tgt_vocab"],
            batch_first=batch_first,
            pad_multiple=int(dataset_args.get("pad_multiple", pad_multiple)),
        )

    @classmethod
    def from_sequences(cls, src: Sequence[Sequence[str]],
                       tgt: Sequence[str],
                       src_vocab: Vocab, tgt_vocab: Vocab,
                       batch_first: bool = True,
                       pad_multiple: int = 8) -> "AslDataset":
        """Numericalize token sequences into padded static-shape arrays
        (replaces the reference's whole-corpus `Field.process` pass,
        asl_dataset.py:157-178)."""
        n = len(src)
        lengths = np.array([len(s) for s in src], dtype=np.int32)
        max_len = int(lengths.max()) if n else 1
        seq = _round_up(max(max_len, 1), max(pad_multiple, 1))

        pad_idx = src_vocab.pad_index
        tokens = np.full((n, seq), pad_idx, dtype=np.int32)
        for i, s in enumerate(src):
            tokens[i, :len(s)] = src_vocab.numericalize(s)

        labels_idx = np.array([tgt_vocab.lookup(t) for t in tgt],
                              dtype=np.int32)
        return cls(tokens, lengths, labels_idx, src_vocab, tgt_vocab,
                   batch_first=batch_first, raw_src=list(src),
                   raw_tgt=list(tgt))

    def stoi(self) -> "AslDataset":
        """Parity no-op: this dataset is always numericalized
        (reference asl_dataset.py:204-208 returns a stoi copy)."""
        return self

    # ------------------------------------------------------------- accessors
    def X(self) -> ArrayView:
        return ArrayView(self.tokens, lengths=self.lengths)

    def y(self) -> ArrayView:
        return ArrayView(self.labels_idx)

    @property
    def vocab_X(self) -> Vocab:
        return self.src_vocab

    @property
    def vocab_y(self) -> Vocab:
        return self.tgt_vocab

    def labels(self, fmt: str = "i") -> list:
        """All target-vocab entries *including* `<unk>`/`<pad>` — the
        reference's documented behavior (asl_dataset.py:210-213), which
        the neg_log_loss scorer depends on (helper.py:536)."""
        fmts = {
            "i": lambda: list(self.tgt_vocab.stoi.values()),
            "s": lambda: list(self.tgt_vocab.stoi.keys()),
        }
        assert fmt in fmts, "Unknown format"
        return fmts[fmt]()

    def __len__(self) -> int:
        return len(self.tokens)

    def __getitem__(self, idx):
        return ((self.tokens[idx], self.lengths[idx]), self.labels_idx[idx])

    @property
    def seq_len(self) -> int:
        return self.tokens.shape[1]

    # ------------------------------------------------------------ transforms
    def select(self, indices) -> "AslDataset":
        indices = np.asarray(indices)
        return AslDataset(self.tokens[indices], self.lengths[indices],
                          self.labels_idx[indices], self.src_vocab,
                          self.tgt_vocab, batch_first=self.batch_first)

    def truncated(self, length: int) -> "AslDataset":
        return self.select(np.arange(min(length, len(self))))

    def split(self, lengths, indices_only: bool = False, seed=None) -> list:
        """Seeded random split. With a float/int `lengths` the return
        order is [split, remainder] — matching the reference's
        `test_data, train_data = dataset.split(test_size)` usage
        (reference main.py:48-50, asl_dataset.py:220-253). The RNG is
        NumPy-based (the torch generator stream is not reproduced)."""
        if not isinstance(lengths, list):
            lengths = [lengths]
        total = len(self)

        def parse(ln):
            if isinstance(ln, float):
                ln = round(ln * total)
            assert isinstance(ln, int)
            return ln

        sizes = [parse(ln) for ln in lengths]
        assert sum(sizes) <= total
        remainder = total - sum(sizes)
        if remainder > 0:
            sizes.append(remainder)

        rng = np.random.default_rng(seed)
        perm = rng.permutation(total)
        out, start = [], 0
        for size in sizes:
            idx = perm[start:start + size]
            out.append(np.sort(idx) if indices_only else self.select(idx))
            start += size
        return out

    def class_counts(self) -> dict:
        vals, counts = np.unique(self.labels_idx, return_counts=True)
        return {int(v): int(c) for v, c in zip(vals, counts)}
