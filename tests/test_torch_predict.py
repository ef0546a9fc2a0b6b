"""The port's serving path end to end, against the JAX package's.

A JAX checkpoint is written with the JAX package's `save_checkpoint` on
the `asl_corpus_dir` fixture, converted to a port checkpoint, and both
`predict_corpus` functions label the corpus: the dicts must be equal.
Then: the port's serving path imports no jax or flax (in a subprocess,
since this process already has them), and `--device cuda` without CUDA
raises. Model sizes: E 32, H 4, L 2, FF 32.
"""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sign_language_nlp_tpu.data.builder import DatasetBuilder
from sign_language_nlp_tpu.models.registry import build_model as jax_build
from sign_language_nlp_tpu.predict import predict_corpus as jax_predict
from sign_language_nlp_tpu.training.checkpoint import (
    save_checkpoint as jax_save_checkpoint)
from sign_language_nlp_torch import predict as port
from sign_language_nlp_torch.models.convert import params_from_jax
from sign_language_nlp_torch.models.registry import build_model
from sign_language_nlp_torch.training.checkpoint import (load_checkpoint,
                                                         load_descriptor,
                                                         save_checkpoint)
from tests.conftest import FIELDS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_ARGS = {"embedding_size": 32, "num_heads": 4, "num_layers": 2,
              "hidden_size": 32, "dropout": 0.1}
# Modules the card's machine does not have: nothing on the port's
# serving path may import them.
ABSENT_ON_CARD = ("jax", "flax", "yaml", "msgpack", "sklearn", "pandas")


def _descriptor(corpus_dir, compat_args):
    """The keys the JAX pipeline writes (pipeline.py:290-303), with
    vocabularies built as training builds them (min_freq 2)."""
    built = DatasetBuilder().build(dataset_dir=corpus_dir, fields=FIELDS,
                                   samples_min_freq=2)
    return {"model": "model.Transformer", "best_params": {"lr": 0.01},
            "model_args": MODEL_ARGS, "compat_args": compat_args,
            "precision_args": {},
            "src_vocab_size": len(built["src_vocab"]),
            "tgt_vocab_size": len(built["tgt_vocab"]),
            "src_vocab_itos": built["src_vocab"].itos,
            "tgt_vocab_itos": built["tgt_vocab"].itos}


def _jax_checkpoint(workdir, corpus_dir, compat_args):
    desc = _descriptor(corpus_dir, compat_args)
    model = jax_build(desc["model"], desc["src_vocab_size"],
                      desc["tgt_vocab_size"], 1, 1,
                      model_args=MODEL_ARGS, compat_args=compat_args)
    tokens = np.full((2, 8), 1, np.int32)
    tokens[:, :3] = 2
    params = model.init({"params": jax.random.key(7)}, tokens,
                        np.array([3, 3], np.int32),
                        np.array([2, 3], np.int32))
    # As the pipeline writes it: a leading population axis [1, ...].
    jax_save_checkpoint(workdir, jax.tree.map(lambda a: np.asarray(a)[None],
                                              params), desc)


def _convert_in_test(src, dst):
    import flax.serialization

    with open(os.path.join(src, "params.msgpack"), "rb") as f:
        tree = flax.serialization.msgpack_restore(f.read())
    save_checkpoint(dst, params_from_jax(tree), load_descriptor(src))


def _convert_with_script(src, dst):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import jax_checkpoint_to_torch
    finally:
        sys.path.remove(os.path.join(REPO, "scripts"))
    jax_checkpoint_to_torch.main(["--src", src, "--dst", dst])


@pytest.mark.parametrize("convert,compat_args", [
    (_convert_in_test, {}),
    (_convert_with_script, {"scan_layers": True, "tgt_input": "bos",
                            "causal_encoder": False}),
], ids=["in_test", "script_scan_layers"])
def test_port_predict_equals_jax(asl_corpus_dir, tmp_path, convert,
                                 compat_args):
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    _jax_checkpoint(jax_dir, asl_corpus_dir, compat_args)
    convert(jax_dir, port_dir)
    assert load_descriptor(port_dir) == load_descriptor(jax_dir)

    want = jax_predict(jax_dir, asl_corpus_dir, fields=FIELDS)
    got = port.predict_corpus(port_dir, asl_corpus_dir, fields=FIELDS,
                              device="cpu", batch_size=16)
    assert len(got) == 45  # every file, min_freq 1 at inference
    assert got == want


@pytest.fixture
def port_checkpoint(asl_corpus_dir, tmp_path):
    """A port checkpoint made by the port alone (seeded torch init)."""
    desc = _descriptor(asl_corpus_dir, {})
    model = build_model(desc["model"], desc["src_vocab_size"],
                        desc["tgt_vocab_size"], 1, 1, model_args=MODEL_ARGS,
                        generator=torch.Generator().manual_seed(0))
    workdir = str(tmp_path / "port")
    save_checkpoint(workdir, model.state_dict(), desc)
    return workdir


def test_checkpoint_round_trip(port_checkpoint):
    model, src_vocab, tgt_vocab, desc = port.load_predictor(port_checkpoint,
                                                            device="cpu")
    assert not model.training
    assert len(src_vocab) == desc["src_vocab_size"]
    saved = load_checkpoint(port_checkpoint)
    for key, value in model.state_dict().items():
        assert torch.equal(value, saved[key]), key


def test_main_writes_predictions(port_checkpoint, asl_corpus_dir, tmp_path):
    out = tmp_path / "preds.json"
    port.main(["--checkpoint", port_checkpoint, "--dataset_dir",
               asl_corpus_dir, "--out", str(out), "--device", "cpu"])
    preds = json.loads(out.read_text())
    assert preds == port.predict_corpus(port_checkpoint, asl_corpus_dir,
                                        fields=FIELDS, device="cpu")
    vocab = set(load_descriptor(port_checkpoint)["tgt_vocab_itos"])
    assert len(preds) == 45 and set(preds.values()) <= vocab


def test_serving_path_imports_no_jax(port_checkpoint, asl_corpus_dir):
    code = (
        "import json, sys\n"
        "from sign_language_nlp_torch.predict import predict_corpus\n"
        f"fields = {FIELDS!r}\n"
        f"preds = predict_corpus({port_checkpoint!r}, {asl_corpus_dir!r},"
        " fields=fields, device='cpu')\n"
        f"bad = sorted({{m.split('.')[0] for m in sys.modules}}"
        f" & set({ABSENT_ON_CARD!r}))\n"
        "print(json.dumps({'n': len(preds), 'bad': bad}))\n")
    env = {**os.environ, "PYTHONPATH": REPO}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"n": 45, "bad": []}


def test_device_cuda_without_cuda_raises(port_checkpoint, asl_corpus_dir):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks its absence")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port.main(["--checkpoint", port_checkpoint, "--dataset_dir",
                   asl_corpus_dir, "--device", "cuda"])
