#!/usr/bin/env python3
"""Where a full-width train step's device time goes, for the port of one
checkout: `chip_smoke.py`'s training profile on its own.

    python3 scripts/profile_torch_training.py [--root CHECKOUT] [--label L]

`--root` is the root of the checkout whose `sign_language_nlp_torch` is
profiled (default: this script's own), so a commit and its parent,
unpacked with `git archive`, can be profiled in turns on one card with
one method. On the synthetic corpus of `chip_smoke.py` (100 classes,
2000 samples, seed 1), one Transformer cell at emb 1024, H 8, L 6, FF
512 with the grid's training settings, dropout 0.5: one torch.profiler
trace of a 14-step fit, read in a window of 10 whole steady steps
(chip_smoke.training_profile). Prints the card's `nvidia-smi` name and
power limit, the profile's lines, then one JSON object. Needs a CUDA
card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--label", default="")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke  # the profile's method, from this checkout

    sys.path.insert(0, os.path.abspath(args.root))  # the port, from root
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        chip_smoke.load_synth().make_corpus(corpus, n_classes=100,
                                            n_samples=2000, seed=1)
        data, train_rows, valid_rows, tgt_v, _, factory = (
            chip_smoke.training_setup(corpus))
        profile = chip_smoke.profile_cell(data, train_rows, valid_rows,
                                          tgt_v, factory)
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0),
                      "profile": profile}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
