"""ASL-Phono corpus builder: directory of per-sample JSON files →
token sequences + label + vocabularies.

Re-implements the reference's `DatasetBuilder`
(reference dataset/builder/dataset_builder.py:14-135) without torchtext:

  1. scan `dataset_dir` for `*.json`, group by filename prefix (the text
     before the first '-'), drop groups with < `samples_min_freq` files
     (dataset_builder.py:66-84);
  2. stream every surviving sample into one JSONL working file, cached
     under a content hash of {dir, fields, min_freq, strategy} when
     `reuse_transient` (dataset_builder.py:29-50). Nulls are replaced by
     "" — here via a proper recursive walk rather than the reference's
     byte-level `.replace('null','""')`;
  3. per sample: compose `frames.phonology` into one token per frame
     with the configured strategy, tokenize the label, and build
     frequency vocabs for source tokens, labels, and filenames.

The port's copy of sign_language_nlp_tpu/data/builder.py, the same code
apart from the C++ fast path of `native/`, which is not ported yet:
`use_native=True` raises.
"""
from __future__ import annotations

import json
import os
import tempfile
import uuid
from collections import Counter
from pathlib import Path

from ..utils import (auto_log_progress, exists, filename, filter_files,
                     get_hash, log, normpath, read_json)
from .compose import COMPOSITION_STRATEGIES
from .vocab import Vocab


def _null_to_empty(obj):
    if obj is None:
        return ""
    if isinstance(obj, dict):
        return {k: _null_to_empty(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_null_to_empty(v) for v in obj]
    return obj


def _get_nested(obj, dotted_key: str):
    node = obj
    for part in dotted_key.split("."):
        node = node[part]
    return node


class DatasetBuilder:
    """Builds the in-memory corpus from an ASL-Phono directory."""

    SRC_KEY = "frames.phonology"
    TGT_KEY = "label"
    FILE_KEY = "file"

    def build(self,
              dataset_dir: str,
              fields,
              samples_min_freq: int,
              batch_first: bool = True,
              composition_strategy: str = "as_words",
              reuse_transient: bool = False,
              use_native: bool = False,
              **kwargs) -> dict:
        log("Loading dataset...")

        if use_native:
            raise NotImplementedError(
                "the C++ corpus loader (sign_language_nlp_tpu/native) is not "
                "ported yet (ROADMAP queue 1 item 1); use_native=False")

        if reuse_transient:
            name = get_hash({
                "dir": dataset_dir,
                "fields": list(fields),
                "min_freq": samples_min_freq,
                "strategy": composition_strategy,
            })
        else:
            name = uuid.uuid4().hex[:12]
        path = normpath(f"{tempfile.gettempdir()}/{name}.dataset.tmp")

        if exists(path):
            log(f"Reusing data file found at '{path}'...")
        else:
            log(f"Creating data file at '{path}'...")
            self.write_working_file(path=path, dataset_dir=dataset_dir,
                                    min_freq=samples_min_freq)

        return self.create_dataset(path=path, fields=fields,
                                   composition_strategy=composition_strategy)

    def write_working_file(self, path: str, dataset_dir: str,
                           min_freq: int) -> None:
        assert exists(dataset_dir), "Invalid dataset directory"
        files = filter_files(dataset_dir, ext="json")

        # Group by filename prefix; keep groups with >= min_freq samples.
        groups: dict[str, list[Path]] = {}
        for f in files:
            groups.setdefault(f.stem.split("-")[0], []).append(f)
        kept = [f for grp in groups.values() if len(grp) >= min_freq
                for f in grp]
        kept.sort()

        tmp_path = f"{path}.part-{os.getpid()}"
        with open(tmp_path, "w") as out:
            for f in auto_log_progress(kept, message="Processing data... ",
                                       every=50):
                data = _null_to_empty(read_json(f))
                data[self.FILE_KEY] = filename(f)
                out.write(json.dumps(data))
                out.write("\n")
        os.replace(tmp_path, path)  # atomic publish for concurrent runs

    def create_dataset(self, path: str, fields,
                       composition_strategy: str) -> dict:
        if composition_strategy not in COMPOSITION_STRATEGIES:
            raise ValueError(
                f"Unknown composition strategy: '{composition_strategy}'")
        compose_fn = COMPOSITION_STRATEGIES[composition_strategy]

        src_sequences: list[list] = []
        tgt_sequences: list[list] = []
        file_names: list[str] = []
        with open(path) as f:
            for line in f:
                if not line.strip():
                    continue
                row = json.loads(line)
                frames = _get_nested(row, self.SRC_KEY)
                src_sequences.append(compose_fn(frames, fields))
                # Labels are whitespace-tokenized like torchtext's default
                # Field tokenizer; ASL glosses are single words.
                tgt_sequences.append(str(row[self.TGT_KEY]).split())
                file_names.append(row[self.FILE_KEY])

        return self._package(src_sequences, tgt_sequences, file_names)

    def _package(self, src_sequences, tgt_sequences, file_names) -> dict:
        src_vocab = Vocab.from_sequences(src_sequences)
        tgt_vocab = Vocab.from_sequences(tgt_sequences)
        file_vocab = Vocab(Counter(file_names))

        return {
            "src": src_sequences,
            "tgt": tgt_sequences,
            "files": file_names,
            "src_vocab": src_vocab,
            "tgt_vocab": tgt_vocab,
            "file_vocab": file_vocab,
        }
