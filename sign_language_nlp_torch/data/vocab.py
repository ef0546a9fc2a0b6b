"""Frequency-ordered vocabulary with special tokens.

Reproduces torchtext-0.6 `Vocab` semantics the reference relies on
(reference dataset/builder/dataset_builder.py:100-135):

  * specials first, in the order (unk, pad) — so `<unk>`=0, `<pad>`=1;
  * then tokens sorted by frequency descending, ties broken
    alphabetically ascending;
  * `stoi` maps unknown tokens (including `<bos>`, which is *not* in the
    vocab — the reference's documented quirk at
    model/base/encoder_decoder_attn_bkp.py:408-413) to the `<unk>` index.
"""
from __future__ import annotations

from collections import Counter
from typing import Iterable, Sequence

from .tokens import PAD_WORD, UNK_WORD


class Vocab:
    def __init__(self, counter: Counter,
                 specials: Sequence[str] = (UNK_WORD, PAD_WORD),
                 min_freq: int = 1):
        self.freqs = Counter(counter)
        min_freq = max(min_freq, 1)

        self.itos: list[str] = list(specials)
        # Sort alphabetically, then stable-sort by freq desc → ties stay
        # alphabetical.
        words = sorted(self.freqs.items())
        words.sort(key=lambda kv: kv[1], reverse=True)
        special_set = set(specials)
        for word, freq in words:
            if freq < min_freq or word in special_set:
                continue
            self.itos.append(word)

        self.stoi: dict[str, int] = {w: i for i, w in enumerate(self.itos)}
        self.unk_index = (self.stoi[UNK_WORD]
                          if UNK_WORD in self.stoi else None)

    @classmethod
    def from_sequences(cls, sequences: Iterable[Sequence[str]],
                       **kwargs) -> "Vocab":
        counter: Counter = Counter()
        for seq in sequences:
            counter.update(seq)
        return cls(counter, **kwargs)

    @classmethod
    def from_itos(cls, itos: Sequence[str]) -> "Vocab":
        """Rebuild a vocab from a persisted index→token list (checkpoint
        descriptors store `itos`; frequencies are not needed for
        inference)."""
        v = cls.__new__(cls)
        v.freqs = Counter()
        v.itos = list(itos)
        v.stoi = {w: i for i, w in enumerate(v.itos)}
        v.unk_index = v.stoi.get(UNK_WORD)
        return v

    def __len__(self) -> int:
        return len(self.itos)

    def __contains__(self, token: str) -> bool:
        return token in self.stoi

    def lookup(self, token: str) -> int:
        """Token → index; unknown tokens map to `<unk>` (torchtext
        defaultdict-stoi behavior)."""
        idx = self.stoi.get(token)
        if idx is None:
            if self.unk_index is None:
                raise KeyError(token)
            return self.unk_index
        return idx

    def numericalize(self, tokens: Sequence[str]) -> list:
        return [self.lookup(t) for t in tokens]

    @property
    def pad_index(self) -> int:
        return self.lookup(PAD_WORD)

    def __repr__(self) -> str:
        return f"Vocab(size={len(self)})"
