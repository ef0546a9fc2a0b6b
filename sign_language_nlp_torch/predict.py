"""Inference CLI: restore a port checkpoint and label a corpus.

    python -m sign_language_nlp_torch.predict \
        --checkpoint <workdir-with-params.pt> \
        --dataset_dir <asl-phono-dir> [--out predictions.json] \
        [--device cuda]

Counterpart of sign_language_nlp_tpu/predict.py:26-128, with the same
arguments and output plus `--device`. The descriptor carries the model,
its args and both vocabularies, so new samples are tokenized with the
SAVED source vocab (unseen tokens → <unk>) and predictions decode
through the saved target vocab. A JAX checkpoint is converted first
with scripts/jax_checkpoint_to_torch.py.

There is no CPU fallback: `--device cuda` without CUDA raises, and the
CPU runs only when asked for by name.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Iterator

import numpy as np
import torch

from .data import AslDataset, DatasetBuilder, Vocab
from .models.registry import build_model
from .models.transformer import Transformer
from .training.checkpoint import load_checkpoint, load_descriptor


def resolve_device(device: str) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available; pass --device cpu to run on the CPU")
    return dev


def load_predictor(checkpoint_dir: str, device: str = "cuda"):
    """Returns (model in eval mode on `device`, src_vocab, tgt_vocab,
    descriptor)."""
    dev = resolve_device(device)
    desc = load_descriptor(checkpoint_dir)
    src_vocab = Vocab.from_itos(desc["src_vocab_itos"])
    tgt_vocab = Vocab.from_itos(desc["tgt_vocab_itos"])
    model = build_model(desc["model"], len(src_vocab), len(tgt_vocab),
                        src_vocab.pad_index, tgt_vocab.pad_index,
                        model_args=desc.get("model_args"),
                        compat_args=desc.get("compat_args"),
                        precision_args=desc.get("precision_args"))
    model.load_state_dict(load_checkpoint(checkpoint_dir))
    return model.to(dev).eval(), src_vocab, tgt_vocab, desc


def load_corpus(dataset_dir: str, fields, src_vocab: Vocab,
                tgt_vocab: Vocab,
                composition_strategy: str = "as_words"
                ) -> tuple[list, AslDataset]:
    """(file names, dataset) of every sample in `dataset_dir`, tokenized
    with the saved vocabularies."""
    built = DatasetBuilder().build(dataset_dir=dataset_dir, fields=fields,
                                   samples_min_freq=1,
                                   composition_strategy=composition_strategy)
    ds = AslDataset.from_sequences(
        src=built["src"], tgt=[t[0] if t else "" for t in built["tgt"]],
        src_vocab=src_vocab, tgt_vocab=tgt_vocab)
    return built["files"], ds


@torch.inference_mode()
def predict_log_probs(model: Transformer, ds: AslDataset,
                      batch_size: int = 256) -> Iterator[np.ndarray]:
    """Log-probs [b, V_tgt] of each batch of `ds`, in order. The tail
    batch runs at its own size (eager PyTorch needs no static shape)."""
    dev = next(model.parameters()).device
    for start in range(0, len(ds), batch_size):
        sl = slice(start, start + batch_size)
        tok, ln, yy = (torch.from_numpy(a[sl]).to(dev)
                       for a in (ds.tokens, ds.lengths, ds.labels_idx))
        yield model(tok, ln, yy).cpu().numpy()


def predict_corpus(checkpoint_dir: str, dataset_dir: str, fields,
                   composition_strategy: str = "as_words",
                   batch_size: int = 256, device: str = "cuda") -> dict:
    """Label every sample in `dataset_dir`; returns {filename: gloss}."""
    model, src_vocab, tgt_vocab, _ = load_predictor(checkpoint_dir, device)
    files, ds = load_corpus(dataset_dir, fields, src_vocab, tgt_vocab,
                            composition_strategy)
    preds = [int(i) for lp in predict_log_probs(model, ds, batch_size)
             for i in lp.argmax(-1)]
    itos = tgt_vocab.itos
    return {f: itos[p] for f, p in zip(files, preds)}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="sign_language_nlp_torch.predict")
    ap.add_argument("--checkpoint", required=True,
                    help="workdir containing params.pt/params.json")
    ap.add_argument("--dataset_dir", required=True)
    ap.add_argument("--fields", default="orientation_dh,orientation_ndh,"
                    "movement_dh,movement_ndh,handshape_dh,handshape_ndh")
    ap.add_argument("--composition_strategy", default="as_words")
    ap.add_argument("--out", default=None, help="output JSON (default "
                    "stdout)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; no CPU fallback)")
    args = ap.parse_args(argv)

    preds = predict_corpus(args.checkpoint, args.dataset_dir,
                           fields=args.fields.split(","),
                           composition_strategy=args.composition_strategy,
                           device=args.device)
    payload = json.dumps(preds, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
        print(f"wrote {len(preds)} predictions to {args.out}",
              file=sys.stderr)
    else:
        print(payload)


if __name__ == "__main__":
    main()
