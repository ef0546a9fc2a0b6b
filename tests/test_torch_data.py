"""The port's own data layer against the JAX package's, on the conftest
corpus: the same vocabularies, token arrays, lengths and labels,
exactly, for every composition strategy."""
import numpy as np
import pytest

from sign_language_nlp_tpu.data import DatasetBuilder as JaxBuilder
from sign_language_nlp_tpu.data import Vocab as JaxVocab
from sign_language_nlp_torch.data import AslDataset, DatasetBuilder, Vocab
from sign_language_nlp_torch.utils import get_hash, read_json, save_json
from tests.conftest import FIELDS


def _args(corpus, strategy="as_words"):
    return {"dataset_dir": corpus, "fields": FIELDS, "samples_min_freq": 2,
            "composition_strategy": strategy, "reuse_transient": False}


@pytest.mark.parametrize("strategy", ["as_words", "all_values",
                                      "as_words_norm", "as_sep_feat"])
def test_builder_matches_jax(asl_corpus_dir, strategy):
    want = JaxBuilder().build(**_args(asl_corpus_dir, strategy))
    got = DatasetBuilder().build(**_args(asl_corpus_dir, strategy))
    for key in ("src", "tgt", "files"):
        assert got[key] == want[key], key
    for key in ("src_vocab", "tgt_vocab", "file_vocab"):
        assert got[key].itos == want[key].itos, key


def test_dataset_matches_jax(asl_corpus_dir, built_dataset):
    got = AslDataset.build(dataset_args=_args(asl_corpus_dir))
    for name in ("tokens", "lengths", "labels_idx"):
        a, b = getattr(got, name), getattr(built_dataset, name)
        assert a.dtype == b.dtype == np.int32, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.src_vocab.itos == built_dataset.src_vocab.itos
    assert got.tgt_vocab.itos == built_dataset.tgt_vocab.itos


def test_vocab_from_itos_matches_jax(built_dataset):
    itos = built_dataset.src_vocab.itos
    got, want = Vocab.from_itos(itos), JaxVocab.from_itos(itos)
    assert got.itos == want.itos and got.pad_index == want.pad_index
    tokens = itos[2:6] + ["never-seen"]
    assert got.numericalize(tokens) == want.numericalize(tokens)


def test_native_loader_is_refused(asl_corpus_dir):
    with pytest.raises(NotImplementedError, match="native"):
        DatasetBuilder().build(**_args(asl_corpus_dir), use_native=True)


def test_utils_io_round_trip(tmp_path):
    obj = {"a": np.int64(3), "b": [np.float32(0.5)], "c": np.arange(2)}
    path = tmp_path / "sub" / "x.json"
    save_json(obj, path)
    assert read_json(path) == {"a": 3, "b": [0.5], "c": [0, 1]}
    assert get_hash({"x": 1, "y": 2}) == get_hash({"y": 2, "x": 1})
