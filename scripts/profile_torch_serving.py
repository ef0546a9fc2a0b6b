#!/usr/bin/env python3
"""Where the device time of the port's serving forward goes, on one GPU.

    python3 scripts/profile_torch_serving.py [--out table.md]

Run from the root of a checkout, on a machine with a CUDA card. It
builds the serving path's configuration (the largest point of the
transformer grid: emb 1024, 8 heads, 6 layers, FF 512, random weights
from seed 0, f32, TF32 off), takes the first batch of 256 from a
synthetic corpus (scripts/make_synth_corpus.py: 100 classes, 2000
samples, seed 1; padded to S 120) and, for the fused CUDA attention
kernel and for the plain attention path:

  * times the forward with CUDA events, 10 forwards after 3 warm-up
    ones, in turns (kernel, plain, plain, kernel, kernel, plain);
  * traces 3 forwards with torch.profiler and prints the
    device time per batch of each kernel and of each kind of kernel
    (GEMM, the fused attention kernel, softmax, LayerNorm, elementwise,
    other), with its share of the device's busy time;
  * prints the device's busy share: the union of the traced kernel,
    memcpy and memset intervals over the span from the first to the
    last of them;
  * prints the GEMM FLOPs of a forward (counted from every nn.Linear
    call) and the rate they ran at.

The trace is written to a temporary directory and removed; `--out`
keeps the printed tables in a file.
"""
from __future__ import annotations

import argparse
import collections
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FULL_WIDTH = {"embedding_size": 1024, "num_heads": 8, "num_layers": 6,
              "hidden_size": 512, "dropout": 0.1}
FIELDS = ["orientation_dh", "orientation_ndh", "movement_dh",
          "movement_ndh", "handshape_dh", "handshape_ndh"]
TIMED, TRACED = 10, 3  # forwards per timed turn, forwards traced per path
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
KINDS = (("fused attention (K1)", r"fused_attention_fwd"),
         ("GEMM", r"gemm|cutlass|xmma"),
         ("softmax", r"softmax"),
         ("LayerNorm", r"layer_norm"),
         ("elementwise", r"elementwise|vectorized"))


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def first_batch(tmp: str):
    """The model on the card and the corpus's first batch of 256."""
    from sign_language_nlp_torch.data import DatasetBuilder
    from sign_language_nlp_torch.models.registry import build_model
    from sign_language_nlp_torch.predict import load_corpus

    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus", os.path.join(ROOT, "scripts",
                                          "make_synth_corpus.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    corpus = os.path.join(tmp, "corpus")
    synth.make_corpus(corpus, n_classes=100, n_samples=2000, seed=1)
    built = DatasetBuilder().build(dataset_dir=corpus, fields=FIELDS,
                                   samples_min_freq=2)
    sv, tv = built["src_vocab"], built["tgt_vocab"]
    model = build_model("model.Transformer", len(sv), len(tv),
                        sv.pad_index, tv.pad_index, model_args=FULL_WIDTH,
                        generator=torch.Generator().manual_seed(0))
    model = model.to("cuda").eval()
    _, ds = load_corpus(corpus, FIELDS, sv, tv)
    batch = tuple(torch.from_numpy(a[:256]).to("cuda")
                  for a in (ds.tokens, ds.lengths, ds.labels_idx))
    return model, batch


def set_backend(model, backend: str) -> None:
    from sign_language_nlp_torch.models.transformer import (
        MultiHeadAttentionBlock)

    for m in model.modules():
        if isinstance(m, MultiHeadAttentionBlock):
            m.backend = backend


def forward_ms(model, batch, iters: int) -> float:
    for _ in range(3):
        model(*batch)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        model(*batch)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def linear_flops(model, batch) -> int:
    """2·rows·in·out summed over every nn.Linear call of one forward."""
    total = 0

    def hook(mod, inputs, _out):
        nonlocal total
        total += 2 * inputs[0].numel() * mod.out_features

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, torch.nn.Linear)]
    model(*batch)
    for h in handles:
        h.remove()
    return total


def device_profile(model, batch, n: int, tmp: str) -> dict:
    """Per-kernel device ms per batch and the busy share over `n`
    traced forwards."""
    from torch.profiler import ProfilerActivity, profile

    model(*batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            model(*batch)
        torch.cuda.synchronize()
    path = os.path.join(tmp, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    dev = [e for e in events if e.get("cat") in DEVICE_CATS and "dur" in e]
    if not any(e["cat"] == "kernel" for e in dev):
        raise SystemExit("profile: the trace holds no device kernels")
    per_name = collections.Counter()
    calls = collections.Counter()
    for e in dev:
        if e["cat"] == "kernel":
            per_name[e["name"]] += e["dur"] / 1e3 / n
            calls[e["name"]] += 1
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in dev)
    busy, (cur_lo, cur_hi) = 0.0, spans[0]
    for lo, hi in spans[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    busy += cur_hi - cur_lo
    window = spans[-1][1] - spans[0][0]
    return {"per_name": per_name, "calls": {k: v // n for k, v in
                                            calls.items()},
            "busy_share": busy / window, "window_ms": window / 1e3 / n}


def tables(label: str, prof: dict, gemm_gflop: float) -> list[str]:
    per_name = prof["per_name"]
    total = sum(per_name.values())
    kinds = collections.Counter()
    for name, ms in per_name.items():
        kinds[kind_of(name)] += ms
    lines = [f"## {label}: {total:.3f} ms of kernels a batch, device busy "
             f"{100 * prof['busy_share']:.1f}% of a "
             f"{prof['window_ms']:.3f} ms span a batch", "",
             "| Kind | ms per batch | share |", "| --- | --- | --- |"]
    lines += [f"| {kind} | {ms:.3f} | {100 * ms / total:.1f}% |"
              for kind, ms in kinds.most_common()]
    gemm_ms = kinds["GEMM"]
    if gemm_ms:
        lines += ["", f"GEMM: {gemm_gflop:.1f} GFLOP of nn.Linear a batch "
                  f"in {gemm_ms:.3f} ms of GEMM kernels, "
                  f"{gemm_gflop / gemm_ms:.1f} TFLOP/s (the plain path's "
                  "GEMM kernels include its attention matmuls)"]
    lines += ["", "| Kernel | calls a batch | ms per batch | share |",
              "| --- | --- | --- | --- |"]
    lines += [f"| `{name[:100]}` | {prof['calls'][name]} | {ms:.3f} | "
              f"{100 * ms / total:.1f}% |"
              for name, ms in per_name.most_common()]
    return lines + [""]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="profile_torch_serving")
    ap.add_argument("--out", default=None, help="also write the tables here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    backends = {"kernel": "auto", "plain": "xla"}

    with tempfile.TemporaryDirectory() as tmp, torch.inference_mode():
        model, batch = first_batch(tmp)
        gemm_gflop = linear_flops(model, batch) / 1e9
        times = collections.defaultdict(list)
        for path in ("kernel", "plain", "plain", "kernel", "kernel",
                     "plain"):
            set_backend(model, backends[path])
            times[path].append(forward_ms(model, batch, TIMED))
        lines = [f"forward ms a batch of 256 ({TIMED} after 3 warm-up, "
                 f"in turns): " + "; ".join(
                     f"{p} " + ", ".join(f"{t:.3f}" for t in ts)
                     for p, ts in times.items()), ""]
        for path in ("kernel", "plain"):
            set_backend(model, backends[path])
            prof = device_profile(model, batch, TRACED, tmp)
            lines += tables(path, prof, gemm_gflop)
    text = "\n".join(lines)
    print(text, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
