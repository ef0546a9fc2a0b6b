#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sign_language_nlp_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit. In order it:

 1. prints the card's `nvidia-smi --query-gpu=name,power.limit` line;
 2. turns TF32 off for matmuls and cuDNN (every check is full f32);
 3. builds the CUDA kernel from csrc/ with nvcc and prints the build time
    and ptxas's register/shared-memory report;
 4. kernel phase: the fused attention kernel against its plain PyTorch
    version, max |diff| <= 1e-4, over head widths D in {16..256}, (Sq, Sk)
    in {(120,120), (1,1), (1,120), (97,97)} and three biases (causal +
    padding, zero, one batch row all NEG_INF);
 5. times kernel and plain version with CUDA events at the encoder's
    shape, q/k/v [256,120,1024] with 8 heads;
 6. slice phase: writes a synthetic corpus (100 classes, 2000 samples),
    saves a full-width Transformer (emb 1024, 8 heads, 6 layers, FF 512)
    with seeded random weights as a port checkpoint, runs
    `sign_language_nlp_torch.predict.main(... --device cuda)`, checks the
    kernel ran 18 times per batch (6 encoder + 6 decoder self + 6 cross
    attentions), and holds the first batch's log-probs against the same
    model on the plain attention path (max |diff| <= 1e-3, same argmax
    wherever the top-2 margin exceeds 1e-3);
 7. prints one {"kernels": [...]} line;
 8. prints {"ok": true, "device": {...}} as the last line.

Any failed check exits non-zero before the last line. Without CUDA, or
outside a checkout of the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import importlib.util
import json
import math
import os
import subprocess
import sys
import tempfile
import time

import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-4     # f32 kernel vs f32 plain version, N(0,1) inputs
LOGPROB_TOL = 1e-3    # six post-LN layers of f32 at width 1024
MARGIN = 1e-3         # argmax must agree where the top-2 gap exceeds this
FULL_WIDTH = {"embedding_size": 1024, "num_heads": 8, "num_layers": 6,
              "hidden_size": 512, "dropout": 0.1}
FIELDS = ["orientation_dh", "orientation_ndh", "movement_dh",
          "movement_ndh", "handshape_dh", "handshape_ndh"]
# (D, E, H) from the transformer grid: E in {128, 512, 1024}, H in {4, 8}.
HEAD_CASES = [(16, 128, 8), (32, 128, 4), (64, 512, 8), (128, 1024, 8),
              (256, 1024, 4)]
SEQ_CASES = [(120, 120), (1, 1), (1, 120), (97, 97)]
BIAS_CASES = ["causal_padding", "zero", "masked_row"]


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


def make_bias(kind: str, B: int, Sq: int, Sk: int, gen, neg_inf):
    """Head-shared [B,Sq,Sk] f32 bias, as the model builds it."""
    bias = torch.zeros((B, Sq, Sk), device="cuda")
    if kind == "causal_padding":
        lengths = torch.randint(1, Sk + 1, (B,), generator=gen,
                                device="cuda")
        lengths[0] = Sk
        keys = torch.arange(Sk, device="cuda")
        bias += torch.where(keys[None, None, :] < lengths[:, None, None],
                            0.0, neg_inf)
        if Sq == Sk:
            bias += torch.triu(torch.full((Sq, Sk), neg_inf, device="cuda"),
                               1)
    elif kind == "masked_row":
        bias[1] = neg_inf
    return bias


def kernel_phase(fa, neg_inf) -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, failures = 0.0, []
    B = 4
    for D, E, H in HEAD_CASES:
        for Sq, Sk in SEQ_CASES:
            for kind in BIAS_CASES:
                q = torch.randn((B, Sq, E), generator=gen, device="cuda")
                k = torch.randn((B, Sk, E), generator=gen, device="cuda")
                v = torch.randn((B, Sk, E), generator=gen, device="cuda")
                bias = make_bias(kind, B, Sq, Sk, gen, neg_inf)
                out = fa.fused_attention_fwd(q, k, v, bias, H)
                ref = fa.fused_attention_reference(q, k, v, bias, H)
                torch.cuda.synchronize()
                err = float((out - ref).abs().max())
                finite = bool(torch.isfinite(out).all())
                worst = max(worst, err)
                status = "ok" if finite and err <= KERNEL_TOL else "FAIL"
                log(f"kernel D={D:3d} E={E:4d} H={H} Sq={Sq:3d} Sk={Sk:3d} "
                    f"bias={kind:14s} max|diff|={err:.3e} {status}")
                if status != "ok":
                    failures.append((D, Sq, Sk, kind, err, finite))
    check(not failures, f"kernel disagrees with its plain version: "
          f"{failures}")
    return worst


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def timing_phase(fa, neg_inf) -> tuple[float, float, float]:
    """Kernel and plain version at the encoder's shape, in turns
    (plain, kernel, kernel, plain); returns (kernel ms, plain ms, max
    |diff|)."""
    B, S, E, H = 256, 120, 1024, 8
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((B, S, E), generator=gen, device="cuda")
               for _ in range(3))
    bias = make_bias("causal_padding", B, S, S, gen, neg_inf)
    err = float((fa.fused_attention_fwd(q, k, v, bias, H)
                 - fa.fused_attention_reference(q, k, v, bias, H))
                .abs().max())
    check(err <= KERNEL_TOL, f"encoder shape: max|diff| {err:.3e}")

    def kernel():
        return fa.fused_attention_fwd(q, k, v, bias, H)

    def plain():
        return fa.fused_attention_reference(q, k, v, bias, H)

    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    kernel_ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
    log(f"timing q/k/v [{B},{S},{E}] H={H} f32: kernel {kernel_ms:.4f} ms "
        f"({k1:.4f}, {k2:.4f}), plain {plain_ms:.4f} ms ({p1:.4f}, "
        f"{p2:.4f}), max|diff|={err:.3e}")
    return kernel_ms, plain_ms, err


def slice_phase(fa, tmp: str) -> dict:
    from sign_language_nlp_torch import predict
    from sign_language_nlp_torch.data import DatasetBuilder
    from sign_language_nlp_torch.models.registry import build_model
    from sign_language_nlp_torch.models.transformer import (
        MultiHeadAttentionBlock)
    from sign_language_nlp_torch.training.checkpoint import save_checkpoint

    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus", os.path.join(ROOT, "scripts",
                                          "make_synth_corpus.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    corpus, ckpt = os.path.join(tmp, "corpus"), os.path.join(tmp, "ckpt")
    synth.make_corpus(corpus, n_classes=100, n_samples=2000, seed=1)

    built = DatasetBuilder().build(dataset_dir=corpus, fields=FIELDS,
                                   samples_min_freq=2)
    src_vocab, tgt_vocab = built["src_vocab"], built["tgt_vocab"]
    desc = {"model": "model.Transformer", "best_params": {},
            "model_args": FULL_WIDTH, "compat_args": {},
            "precision_args": {}, "src_vocab_size": len(src_vocab),
            "tgt_vocab_size": len(tgt_vocab),
            "src_vocab_itos": src_vocab.itos,
            "tgt_vocab_itos": tgt_vocab.itos}
    model = build_model(desc["model"], len(src_vocab), len(tgt_vocab),
                        src_vocab.pad_index, tgt_vocab.pad_index,
                        model_args=FULL_WIDTH,
                        generator=torch.Generator().manual_seed(0))
    save_checkpoint(ckpt, model.state_dict(), desc)
    del model

    out_path = os.path.join(tmp, "preds.json")
    fa.fused_attention_fwd.launches = 0
    t0 = time.perf_counter()
    predict.main(["--checkpoint", ckpt, "--dataset_dir", corpus,
                  "--out", out_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = fa.fused_attention_fwd.launches
    with open(out_path) as f:
        preds = json.load(f)
    n = len(preds)
    n_batches = math.ceil(n / 256)
    per_batch = 3 * FULL_WIDTH["num_layers"]
    log(f"slice: predict.main labelled {n} samples in {n_batches} batches, "
        f"{wall:.3f} s end to end ({n / wall:.1f} samples/s incl. load), "
        f"kernel launches {launches}")
    n_files = len([f for f in os.listdir(corpus) if f.endswith(".json")])
    check(n == n_files, f"{n} predictions for {n_files} samples")
    check(set(preds.values()) <= set(tgt_vocab.itos), "unknown labels")
    check(launches == per_batch * n_batches,
          f"kernel launched {launches} times, want {per_batch} x "
          f"{n_batches}")

    model, sv, tv, _ = predict.load_predictor(ckpt, device="cuda")
    files, ds = predict.load_corpus(corpus, FIELDS, sv, tv)
    check(ds.tokens.shape[1] == 120, f"padded length {ds.tokens.shape[1]}")
    t0 = time.perf_counter()
    batches = list(predict.predict_log_probs(model, ds))
    fwd = time.perf_counter() - t0
    lp = torch.from_numpy(batches[0])
    for m in model.modules():
        if isinstance(m, MultiHeadAttentionBlock):
            m.backend = "xla"
    plain = torch.from_numpy(next(predict.predict_log_probs(model, ds)))
    check(lp.shape == (min(256, n), len(tv)), f"log-probs {lp.shape}")
    check(bool(torch.isfinite(lp).all()), "non-finite log-probs")
    err = float((lp - plain).abs().max())
    top2 = plain.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > MARGIN
    agree = bool((lp.argmax(-1) == plain.argmax(-1))[decided].all())
    labels = [tv.itos[i] for i in lp.argmax(-1).tolist()]
    check(labels == [preds[f] for f in files[:len(labels)]],
          "first batch's labels differ from predict.main's")
    log(f"slice: first batch log-probs kernel vs plain max|diff|={err:.3e} "
        f"(tol {LOGPROB_TOL}), argmax agrees on {int(decided.sum())} rows "
        f"with top-2 margin > {MARGIN}: {agree}; forward only "
        f"{n / fwd:.1f} samples/s")
    check(err <= LOGPROB_TOL, f"log-probs differ by {err:.3e}")
    check(agree, "argmax differs where the margin is clear")
    return {"launches": launches, "logprob_err": err}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs a GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(ROOT, "sign_language_nlp_torch")):
        print("chip_smoke: run from the root of a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    from sign_language_nlp_torch.kernels import build
    from sign_language_nlp_torch.ops import fused_attention as fa
    from sign_language_nlp_torch.ops.attention import NEG_INF

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    built = build.build("fused_attention_fwd.cu")
    log(f"build: {os.path.basename(built.library)} in {built.seconds:.2f} s"
        f"{' (already built)' if built.seconds == 0.0 else ''}")
    if os.path.exists(built.log):
        with open(built.log) as f:
            for line in f:
                if any(w in line for w in ("entry function", "registers",
                                           "spill")):
                    log("ptxas: " + line.strip())
    build.fused_attention_library()

    worst = kernel_phase(fa, NEG_INF)
    kernel_ms, plain_ms, enc_err = timing_phase(fa, NEG_INF)
    with tempfile.TemporaryDirectory() as tmp:
        result = slice_phase(fa, tmp)

    log(json.dumps({"kernels": [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "sign_language_nlp_torch/csrc/fused_attention_fwd.cu",
        "replaces": "sign_language_nlp_tpu/ops/pallas_attention_train.py:111",
        "launches": result["launches"],
        "max_abs_err": max(worst, enc_err),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
