#!/usr/bin/env python3
"""Time the port's fused attention kernels K1 and K2 through their
wrappers, at the shapes the model paths launch them with, for the port
of one checkout.

    python3 scripts/time_attention_kernels.py [--root CHECKOUT] [--label L]

`--root` is the root of the checkout whose `sign_language_nlp_torch`
is timed (default: this script's own), so two checkouts, for example a
commit and its parent unpacked with `git archive`, can be timed in
turns on one card and compared. Every shape is q [B,Sq,E], k/v [B,Sk,E]
at E 1024, H 8 (D 128), with the encoder's causal + padding bias where
Sq = Sk and a padding bias otherwise:

  * serving: K1 at [256,120,120] (encoder self) and [256,1,120]
    (decoder cross), dropout off;
  * training: K1 with dropout 0.1 and K2 at [50,120,120] (encoder self),
    [50,1,120] (decoder cross) and [50,1,1] (decoder self).

Times are CUDA-event ms per call (20 calls after 3 of warm-up), the
wrapper's host work included, as the model paths pay it. Prints the
card's `nvidia-smi` name and power limit, then one JSON object. Needs a
CUDA card; exits 2 without one.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

NEG_INF = -1e30
SERVING = ((256, 120, 120), (256, 1, 120))
TRAINING = ((50, 120, 120), (50, 1, 120), (50, 1, 1))
E, H, RATE = 1024, 8, 0.1


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


def device_ms(fn, iters: int = 10) -> dict:
    """Device ms per call by kernel name, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / 1e3 / iters
            for e in prof.key_averages() if e.device_time_total > 0}


def inputs(B: int, Sq: int, Sk: int, gen: torch.Generator):
    q, dout = (torch.randn((B, Sq, E), generator=gen, device="cuda")
               for _ in range(2))
    k, v = (torch.randn((B, Sk, E), generator=gen, device="cuda")
            for _ in range(2))
    lengths = torch.randint(1, Sk + 1, (B,), generator=gen, device="cuda")
    keys = torch.arange(Sk, device="cuda")
    bias = torch.where(keys[None, None, :] < lengths[:, None, None], 0.0,
                       NEG_INF).expand(B, Sq, Sk).contiguous()
    if Sq == Sk:
        bias += torch.triu(torch.full((Sq, Sk), NEG_INF, device="cuda"), 1)
    seeds = torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device="cuda",
                          dtype=torch.int32)
    return q, k, v, bias, dout, seeds


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    parser.add_argument("--label", default="")
    parser.add_argument("--profile", action="store_true",
                        help="also device ms by kernel name")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("time_attention_kernels: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from sign_language_nlp_torch.ops import fused_attention as fa

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(11)
    rows = []

    def row(kernel, shape, rate, fn):
        r = {"kernel": kernel, "shape": list(shape), "rate": rate,
             "ms": cuda_ms(fn)}
        if args.profile:
            r["device_ms"] = device_ms(fn)
        rows.append(r)
        print(f"{args.label} {kernel} {list(shape)} rate {rate}: "
              f"{r['ms']:.4f} ms {r.get('device_ms', '')}", flush=True)

    for shape in SERVING:
        q, k, v, bias, _, _ = inputs(*shape, gen)
        row("K1", shape, 0.0, lambda: fa.fused_attention_fwd(q, k, v, bias,
                                                              H))
    for shape in TRAINING:
        q, k, v, bias, dout, seeds = inputs(*shape, gen)
        _, stats = fa.fused_attention_fwd(q, k, v, bias, H, seeds, RATE,
                                          return_stats=True)
        row("K1", shape, RATE, lambda: fa.fused_attention_fwd(
            q, k, v, bias, H, seeds, RATE, return_stats=True))
        row("K2", shape, RATE, lambda: fa.fused_attention_bwd(
            q, k, v, bias, dout, stats, H, seeds, RATE))
    print(json.dumps({"label": args.label, "root": args.root,
                      "device": torch.cuda.get_device_name(0),
                      "rows": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
