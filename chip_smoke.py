#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (sign_language_nlp_torch) on one
NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and the
CUDA toolkit. In order it:

 1. prints the card's `nvidia-smi --query-gpu=name,power.limit` line;
 2. turns TF32 off for matmuls and cuDNN (every check is full f32);
 3. builds the three CUDA sources from csrc/ with nvcc, one process
    each, started together, and prints the build times and ptxas's
    register/shared-memory report;
 4. K1 phase: the fused attention forward against its plain PyTorch
    version, max |diff| <= 1e-4, over head widths D in {8, 12, 16, 24,
    32, 64, 128, 256}, (Sq, Sk) in {(120,120), (1,1), (1,120), (97,97)}
    and four biases (causal + padding, zero, one batch row all NEG_INF,
    one unmasked key a row);
 5. K1 dropout phase: the same grid at rates 0.1 and 0.5 against the
    plain version with the same keep-mask (`dropout_keep_mask`), max
    |diff| <= 1e-4; then the mask probe (V a per-head identity, so the
    output is the dropped-out probabilities): the kernel's mask equals
    `dropout_keep_mask` exactly and keeps 1 - rate within 0.02;
 6. K2 phase: the fused backward against autograd of the plain version
    with the same mask, rates 0, 0.1 and 0.5, the same grid, loss
    sum(out^2): max |diff| of dq, dk, dv <= 1e-4 * max(1, max|ref|)
    (3xTF32 products and the order of the f32 sums differ), and with one
    unmasked key a row, dq exactly 0 in both;
 7. K3 phase: the single-head fused attention kernel against its plain
    version, max |diff| <= 1e-4, over D in {8, 24, 64, 128, 256}, (Sq,
    Sk) in {(120,120), (1,1), (1,120), (97,97), (120,37)} and four
    per-slice biases (N(0,1); causal + padding from per-row lengths,
    expanded per head; the last 4 keys masked; N(0,1) with one slice's
    row fully masked), at BH 6, plus one case at BH 70000;
 8. K3 path phase: the op's entry point `fused_attention_bh`, forward
    and gradient, at the grid's full width in head-split layout (q/k/v
    [400,120,128], 50 rows x 8 heads, the encoder's causal + padding
    bias per slice, gradients for q, k, v and the bias, loss
    sum(out^2)) against the all-plain path: loss within 1e-4 relative,
    dq, dk, dv, dbias within 1e-4 * max(1, max|ref|), one K3 launch per
    forward and none of K1 or K2; then the forward alone at the serving
    shape [2048,120,128];
 9. timing, CUDA events, in turns (plain, kernel, kernel, plain): K1 at
    the serving shape q/k/v [256,120,1024] with 8 heads; K1 with dropout
    0.1 and K2 at the training shape [50,120,1024], where two K2
    launches on the same inputs must give equal outputs, and at the
    decoder's cross-attention shape (q [50,1,1024], k/v [50,120,1024]);
    K3 at [2048,120,128] (K1's serving arithmetic, head-split) and
    [400,120,128]; beside them, for the record only,
    F.scaled_dot_product_attention with a float mask (the forward
    without dropout, and its backward); bounds at the f32 CUDA-core
    rate and, for K1 and K2, at the dense TF32 rate for 3xTF32;
10. serving slice: writes a synthetic corpus (100 classes, 2000
    samples), saves a full-width Transformer (emb 1024, 8 heads, 6
    layers, FF 512) with seeded random weights as a port checkpoint,
    runs `sign_language_nlp_torch.predict.main(... --device cuda)`,
    checks K1 ran 18 times per batch (6 encoder + 6 decoder self + 6
    cross attentions), and holds the first batch's log-probs against the
    same model on the plain attention path (max |diff| <= 1e-3, same
    argmax wherever the top-2 margin exceeds 1e-3);
11. training slice: `PopulationTrainer.fit` at the same width on the
    same corpus and its monitor split (`train_valid_split`), P = 2 cells
    (lr 0.1 with dropout 0.5, lr 0.01 with dropout 0.1), 2 epochs, with
    the transformer grid's training settings; checks finite losses and
    metrics, history [2, 2], K1 launches = 18 x (train steps + eval
    batches), K1 dropout launches and K2 launches = 18 x train steps;
    then one first step of each cell from the same weights and seeds
    through the kernels and through the plain path: losses within 1e-4,
    global gradient norms within 1e-3 relative; then, from one
    torch.profiler trace of a 14-step one-cell fit, a window of 10
    whole steady train steps marked by every 18th K1 launch: kernel ms
    per step by kind, memcpy and memset apart, and the device's busy
    share in the window, which must lie in (0, 1];
    Neither slice launches K3: no model path goes to it, in the JAX
    package either;
12. prints one {"training": {...}} line (the slice's counts, wall time
    and peak memory), then one {"kernels": [...]} line: per kernel (K1
    without and with dropout, K2, K3) its launches on each path, its
    error against its plain version, and its time, its plain version's,
    the library call's and its bound at the path's shape;
13. prints {"ok": true, "device": {...}} as the last line.

Any failed check exits non-zero before the last line. Without CUDA, or
outside a checkout of the repo, it exits non-zero and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import importlib.util
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
KERNEL_TOL = 1e-4     # f32 kernel vs f32 plain version, N(0,1) inputs
GRAD_TOL = 1e-4       # K2 vs autograd, relative to max(1, max|ref|)
KEEP_TOL = 0.02       # keep fraction of the mask probe vs 1 - rate
LOGPROB_TOL = 1e-3    # six post-LN layers of f32 at width 1024
MARGIN = 1e-3         # argmax must agree where the top-2 gap exceeds this
STEP_LOSS_TOL = 1e-4  # first training step, kernels vs plain path
STEP_NORM_RTOL = 1e-3
FULL_WIDTH = {"embedding_size": 1024, "num_heads": 8, "num_layers": 6,
              "hidden_size": 512, "dropout": 0.1}
# configs/config-transformer.yaml:13-47: the grid's training settings.
TRAIN_SETTINGS = dict(
    optimizer="torch.optim.SGD",
    optimizer_args={"nesterov": False, "momentum": 0.9},
    criterion="torch.nn.CrossEntropyLoss", batch_size=50,
    gradient_clipping={"gradient_clip_value": 0.5},
    lr_scheduler={"policy": "ReduceLROnPlateau", "factor": 0.2,
                  "patience": 5},
    early_stopping={"patience": 30, "threshold": 1e-4,
                    "threshold_mode": "rel"},
    scoring=("neg_log_loss", "accuracy", "precision_weighted",
             "recall_weighted", "f1_weighted"),
    eval_batch_size=256, seed=1)
CELLS = ((0.1, 0.5), (0.01, 0.1))  # (lr, dropout) of the two cells
FIELDS = ["orientation_dh", "orientation_ndh", "movement_dh",
          "movement_ndh", "handshape_dh", "handshape_ndh"]
# (D, E, H) from the transformer grid (E in {128, 512, 1024}, H in {4,
# 8}), and widths off the grid that the kernels pad (D 8, 12, 24).
HEAD_CASES = [(16, 128, 8), (32, 128, 4), (64, 512, 8), (128, 1024, 8),
              (256, 1024, 4), (8, 32, 4), (12, 48, 4), (24, 96, 4)]
SEQ_CASES = [(120, 120), (1, 1), (1, 120), (97, 97)]
BIAS_CASES = ["causal_padding", "zero", "masked_row", "one_key"]
# K3: head widths (any D <= 256), sequence shapes and per-slice biases.
K3_HEAD_DIMS = (8, 24, 64, 128, 256)
K3_SEQ_CASES = [(120, 120), (1, 1), (1, 120), (97, 97), (120, 37)]
K3_BIAS_CASES = ["normal", "causal_padding", "last4", "masked_row"]
# Kinds of device kernel in a training step's trace, by name.
KINDS = (("K1 (fused attention forward)", r"fused_attention_fwd"),
         ("K2 (fused attention backward)", r"attention_bwd"),
         ("GEMM", r"gemm|cutlass|xmma"),
         ("optimizer and clipping (foreach)", r"multi_tensor|foreach"),
         ("reduction", r"reduce"),
         ("LayerNorm", r"layer_norm"),
         ("softmax", r"softmax"),
         ("embedding", r"embedding|index|scatter|gather"),
         ("elementwise", r"elementwise|vectorized"))
PROFILE_SKIP = 2     # warm train steps before the profile's window
PROFILE_STEPS = 10   # whole steady train steps in the profile's window
STEP_MARK = r"fused_attention_fwd"  # K1: 18 launches a train step
F32_PEAK = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
TF32_PEAK = 495e12   # H100 SXM dense TF32 FLOP/s on the tensor cores
HBM_RATE = 3.35e12   # H100 SXM device memory bytes/s


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
    elif kind == "one_key":  # every row leaves exactly one key unmasked
        keys = torch.randint(0, Sk, (B, Sq, 1), generator=gen, device="cuda")
        bias.fill_(neg_inf).scatter_(2, keys, 0.0)
    return bias


def make_seeds(B: int, gen) -> torch.Tensor:
    return torch.randint(0, 2 ** 31 - 1, (B,), generator=gen, device="cuda",
                         dtype=torch.int32)


def make_bh_bias(kind: str, B: int, H: int, Sq: int, Sk: int, gen,
                 neg_inf) -> torch.Tensor:
    """Per-slice [B*H,Sq,Sk] f32 bias for K3: "normal" N(0,1);
    "causal_padding" from per-row lengths, expanded per head, as the
    encoder's mask; "last4" the last 4 keys masked (the JAX test's
    fixture); "masked_row" N(0,1) with one slice's middle row all
    NEG_INF."""
    if kind == "causal_padding":
        return make_bias(kind, B, Sq, Sk, gen, neg_inf).repeat_interleave(
            H, dim=0)
    if kind == "last4":
        bias = torch.zeros((B * H, Sq, Sk), device="cuda")
        bias[:, :, -4:] = neg_inf
        return bias
    bias = torch.randn((B * H, Sq, Sk), generator=gen, device="cuda")
    if kind == "masked_row":
        bias[1, Sq // 2] = neg_inf
    return bias


def reset_counts(fa, fab) -> None:
    """Every kernel's launch count to 0."""
    fa.fused_attention_fwd.launches = 0
    fa.fused_attention_fwd.dropout_launches = 0
    fa.fused_attention_bwd.launches = 0
    fab.fused_attention_bh_fwd.launches = 0


def case_grid():
    for D, E, H in HEAD_CASES:
        for Sq, Sk in SEQ_CASES:
            for kind in BIAS_CASES:
                yield D, E, H, Sq, Sk, kind


def build_phase(build) -> None:
    """Every source at once, one nvcc each."""
    with concurrent.futures.ThreadPoolExecutor(len(build.SOURCES)) as pool:
        builds = list(pool.map(build.build, build.SOURCES))
    for source, built in zip(build.SOURCES, builds):
        log(f"build: {source} -> {os.path.basename(built.library)} in "
            f"{built.seconds:.2f} s"
            f"{' (already built)' if built.seconds == 0.0 else ''}")
        if os.path.exists(built.log):
            with open(built.log) as f:
                for line in f:
                    if any(w in line for w in ("entry function", "registers",
                                               "spill")):
                        log("ptxas: " + line.strip())
    build.fused_attention_library()
    build.fused_attention_bwd_library()
    build.fused_attention_bh_library()


def kernel_phase(fa, neg_inf) -> float:
    gen = torch.Generator(device="cuda").manual_seed(0)
    worst, failures = 0.0, []
    B = 4
    for D, E, H, Sq, Sk, kind in case_grid():
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


def dropout_phase(fa, neg_inf) -> float:
    """K1's dropout branch against the same-mask plain version, then the
    mask probe."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    worst, failures = 0.0, []
    B = 4
    for rate in (0.1, 0.5):
        for D, E, H, Sq, Sk, kind in case_grid():
            q = torch.randn((B, Sq, E), generator=gen, device="cuda")
            k = torch.randn((B, Sk, E), generator=gen, device="cuda")
            v = torch.randn((B, Sk, E), generator=gen, device="cuda")
            bias = make_bias(kind, B, Sq, Sk, gen, neg_inf)
            seeds = make_seeds(B, gen)
            out = fa.fused_attention_fwd(q, k, v, bias, H, seeds, rate)
            keep = fa.dropout_keep_mask(seeds, H, Sq, Sk, rate)
            ref = fa.fused_attention_reference(q, k, v, bias, H, keep, rate)
            torch.cuda.synchronize()
            err = float((out - ref).abs().max())
            finite = bool(torch.isfinite(out).all())
            worst = max(worst, err)
            status = "ok" if finite and err <= KERNEL_TOL else "FAIL"
            log(f"dropout rate={rate} D={D:3d} H={H} Sq={Sq:3d} Sk={Sk:3d} "
                f"bias={kind:14s} max|diff|={err:.3e} {status}")
            if status != "ok":
                failures.append((rate, D, Sq, Sk, kind, err, finite))
    check(not failures, f"K1 dropout disagrees with its plain version: "
          f"{failures}")

    # Mask probe (scripts/validate_pallas_tpu.py:59-69): V is a per-head
    # identity over the keys, so head h's output columns are P_d.
    B, S, E, H = 4, 120, 1024, 8
    D = E // H
    q, k = (torch.randn((B, S, E), generator=gen, device="cuda")
            for _ in range(2))
    eye = torch.zeros((B, S, E), device="cuda")
    for h in range(H):
        eye[:, :, h * D:h * D + S] = torch.eye(S, device="cuda")
    bias = torch.zeros((B, S, S), device="cuda")
    for rate in (0.1, 0.5):
        seeds = make_seeds(B, gen)
        pd = fa.fused_attention_fwd(q, k, eye, bias, H, seeds, rate)
        mask = torch.stack([pd[:, :, h * D:h * D + S] > 0 for h in range(H)],
                           dim=1)
        want = fa.dropout_keep_mask(seeds, H, S, S, rate)
        frac = float(mask.float().mean())
        same = bool(torch.equal(mask, want))
        log(f"mask probe rate={rate}: keep fraction {frac:.4f} (want "
            f"{1 - rate} +- {KEEP_TOL}), kernel mask == dropout_keep_mask: "
            f"{same}")
        check(same, f"rate {rate}: the kernel's mask is not "
              "dropout_keep_mask's")
        check(abs(frac - (1 - rate)) <= KEEP_TOL,
              f"rate {rate}: keep fraction {frac:.4f}")
    return worst


def _plain_grads(fa, q, k, v, bias, H, seeds, rate):
    q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
    keep = (fa.dropout_keep_mask(seeds, H, q.shape[1], k.shape[1], rate)
            if rate else None)
    out = fa.fused_attention_reference(q, k, v, bias, H, keep, rate)
    return torch.autograd.grad((out ** 2).sum(), (q, k, v))


def backward_phase(fa, neg_inf) -> float:
    """K2 through the autograd function against autograd of the plain
    version, same mask; returns the worst (absolute, relative) error."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    worst, worst_abs, failures = 0.0, 0.0, []
    B = 4
    for rate in (0.0, 0.1, 0.5):
        for D, E, H, Sq, Sk, kind in case_grid():
            q = torch.randn((B, Sq, E), generator=gen, device="cuda")
            k = torch.randn((B, Sk, E), generator=gen, device="cuda")
            v = torch.randn((B, Sk, E), generator=gen, device="cuda")
            bias = make_bias(kind, B, Sq, Sk, gen, neg_inf)
            seeds = make_seeds(B, gen)
            qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
            out = fa.fused_attention(qg, kg, vg, bias, H, seeds, rate)
            got = torch.autograd.grad((out ** 2).sum(), (qg, kg, vg))
            ref = _plain_grads(fa, q, k, v, bias, H, seeds, rate)
            torch.cuda.synchronize()
            diffs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
            errs = [d / max(1.0, float(r.abs().max()))
                    for d, r in zip(diffs, ref)]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            err = max(errs)
            worst = max(worst, err)
            worst_abs = max([worst_abs, *diffs])
            # One unmasked key a row: P is exactly one-hot, so dS and dq
            # are exactly 0, in autograd of the plain version and in K2.
            zeros = (kind != "one_key"
                     or (bool((got[0] == 0).all())
                         and bool((ref[0] == 0).all())))
            status = "ok" if finite and zeros and err <= GRAD_TOL else "FAIL"
            log(f"backward rate={rate} D={D:3d} H={H} Sq={Sq:3d} Sk={Sk:3d} "
                f"bias={kind:14s} rel max|diff| dq {errs[0]:.3e} dk "
                f"{errs[1]:.3e} dv {errs[2]:.3e}"
                f"{' dq == 0' if kind == 'one_key' and zeros else ''} "
                f"{status}")
            if status != "ok":
                failures.append((rate, D, Sq, Sk, kind, errs, finite, zeros))
    check(not failures, f"K2 disagrees with autograd of the plain version: "
          f"{failures}")
    return worst_abs, worst


def k3_phase(fab, neg_inf) -> float:
    """K3 against its plain version on per-slice biases, any D <= 256."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst, failures = 0.0, []
    cases = [(2, 3, D, Sq, Sk, kind) for D in K3_HEAD_DIMS
             for Sq, Sk in K3_SEQ_CASES for kind in K3_BIAS_CASES]
    cases.append((70000, 1, 24, 2, 3, "normal"))  # BH beyond 65535
    for B, H, D, Sq, Sk, kind in cases:
        q = torch.randn((B * H, Sq, D), generator=gen, device="cuda")
        k = torch.randn((B * H, Sk, D), generator=gen, device="cuda")
        v = torch.randn((B * H, Sk, D), generator=gen, device="cuda")
        bias = make_bh_bias(kind, B, H, Sq, Sk, gen, neg_inf)
        out = fab.fused_attention_bh_fwd(q, k, v, bias)
        ref = fab.fused_attention_bh_reference(q, k, v, bias)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        finite = bool(torch.isfinite(out).all())
        worst = max(worst, err)
        status = "ok" if finite and err <= KERNEL_TOL else "FAIL"
        log(f"K3 BH={B * H:5d} D={D:3d} Sq={Sq:3d} Sk={Sk:3d} "
            f"bias={kind:14s} max|diff|={err:.3e} {status}")
        if status != "ok":
            failures.append((B * H, D, Sq, Sk, kind, err, finite))
    check(not failures, f"K3 disagrees with its plain version: {failures}")
    return worst


def k3_path_phase(fa, fab, neg_inf) -> dict:
    """The op's entry point, as the JAX tests run it, at the grid's full
    width in head-split layout: forward and gradient at [400,120,128]
    against the all-plain path, then the forward alone at the serving
    shape [2048,120,128]. The counts are read over both calls."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    H, S, D = 8, 120, 128

    def inputs(B):
        qkv = [torch.randn((B * H, S, D), generator=gen, device="cuda")
               for _ in range(3)]
        return qkv + [make_bh_bias("causal_padding", B, H, S, S, gen,
                                   neg_inf)]

    train, serving = inputs(50), inputs(256)
    plain_in = [t.clone().requires_grad_() for t in train]
    plain_out = fab.fused_attention_bh_reference(*plain_in)
    plain_loss = (plain_out ** 2).sum()
    ref = torch.autograd.grad(plain_loss, plain_in)
    got_in = [t.clone().requires_grad_() for t in train]
    torch.cuda.synchronize()

    reset_counts(fa, fab)
    out = fab.fused_attention_bh(*got_in)
    loss = (out ** 2).sum()
    got = torch.autograd.grad(loss, got_in)
    after_grad = fab.fused_attention_bh_fwd.launches
    serving_out = fab.fused_attention_bh(*serving)
    torch.cuda.synchronize()
    launches = fab.fused_attention_bh_fwd.launches
    others = (fa.fused_attention_fwd.launches
              + fa.fused_attention_bwd.launches)

    loss, plain_loss = float(loss.detach()), float(plain_loss.detach())
    loss_err = abs(loss - plain_loss) / abs(plain_loss)
    fwd_err = float((out - plain_out).detach().abs().max())
    diffs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    errs = [d / max(1.0, float(r.abs().max())) for d, r in zip(diffs, ref)]
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    serving_err = float((serving_out
                         - fab.fused_attention_bh_reference(*serving))
                        .abs().max())
    log(f"K3 path: q/k/v [{50 * H},{S},{D}] loss kernel {loss:.6f} "
        f"plain {plain_loss:.6f} (rel {loss_err:.3e}), out "
        f"max|diff| {fwd_err:.3e}; rel max|diff| "
        + ", ".join(f"{n} {e:.3e}" for n, e in zip(("dq", "dk", "dv",
                                                     "dbias"), errs))
        + f"; serving forward [{256 * H},{S},{D}] max|diff| "
        f"{serving_err:.3e}; launches K3 {launches} ({after_grad} with the "
        f"gradient), K1 + K2 {others}")
    check(loss_err <= 1e-4, f"K3 path: loss differs by {loss_err:.3e}")
    check(fwd_err <= KERNEL_TOL and serving_err <= KERNEL_TOL,
          f"K3 path: forward differs by {fwd_err:.3e}, {serving_err:.3e}")
    check(finite and max(errs) <= GRAD_TOL,
          f"K3 path: gradients differ by {errs} (finite {finite})")
    check(after_grad == 1 and launches == 2 and others == 0,
          f"K3 path: launches K3 {after_grad} then {launches}, K1 + K2 "
          f"{others}; want 1, 2 and 0")
    return {"launches": launches, "loss_rel_err": loss_err,
            "max_abs_err": max(fwd_err, serving_err),
            "grad_abs_err": max(diffs), "grad_rel_err": max(errs)}


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


def in_turns(plain, kernel, label: str) -> tuple[float, float]:
    """(kernel ms, plain ms), each the mean of two turns of
    (plain, kernel, kernel, plain)."""
    p1, k1, k2, p2 = (cuda_ms(f) for f in (plain, kernel, kernel, plain))
    log(f"timing {label}: kernel {(k1 + k2) / 2:.4f} ms ({k1:.4f}, "
        f"{k2:.4f}), plain {(p1 + p2) / 2:.4f} ms ({p1:.4f}, {p2:.4f})")
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(flop: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, ms, and what sets it."""
    ops_ms, bytes_ms = flop / F32_PEAK * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms,
                                                             "bytes")


def tf32_bound(flop: float, nbytes: float) -> float:
    """The least time, ms, of the same work as 3xTF32 on the tensor cores
    (three TF32 products for each f32 one), or of its bytes."""
    return max(3.0 * flop / TF32_PEAK, nbytes / HBM_RATE) * 1e3


def _sdpa_inputs(q, k, v, bias, H):
    """[B,S,E] model layout → SDPA's [B,H,S,D] views and a float mask
    [B,1,Sq,Sk] (the head-shared bias)."""
    B, Sq, E = q.shape
    D = E // H

    def heads(t):
        return t.view(B, t.shape[1], H, D).transpose(1, 2)

    return heads(q), heads(k), heads(v), bias[:, None]


def timing_phase(fa, neg_inf) -> dict:
    """Times of every kernel of the path at the path's shapes, with the
    plain version's and the library call's, and the bound of each."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(1)
    rows = {}

    # K1, dropout off, at the serving shape.
    B, S, E, H = 256, 120, 1024, 8
    q, k, v = (torch.randn((B, S, E), generator=gen, device="cuda")
               for _ in range(3))
    bias = make_bias("causal_padding", B, S, S, gen, neg_inf)
    err = float((fa.fused_attention_fwd(q, k, v, bias, H)
                 - fa.fused_attention_reference(q, k, v, bias, H))
                .abs().max())
    check(err <= KERNEL_TOL, f"serving shape: max|diff| {err:.3e}")
    kernel_ms, plain_ms = in_turns(
        lambda: fa.fused_attention_reference(q, k, v, bias, H),
        lambda: fa.fused_attention_fwd(q, k, v, bias, H),
        f"K1 q/k/v [{B},{S},{E}] H={H} f32")
    sq, sk, sv, smask = _sdpa_inputs(q, k, v, bias, H)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask))
    fwd_flop = 4.0 * B * S * S * E
    fwd_bytes = 4.0 * (4 * B * S * E + B * S * S)
    b_ms, b_by = bound(fwd_flop, fwd_bytes)
    log(f"timing K1 serving: library (SDPA, float mask) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), 3xTF32 bound "
        f"{tf32_bound(fwd_flop, fwd_bytes):.4f} ms")
    rows["fwd"] = {"ms": kernel_ms, "plain_ms": plain_ms, "library_ms":
                   lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "tf32_bound_ms": tf32_bound(fwd_flop, fwd_bytes),
                   "max_abs_err": err, "shape": [B, S, E, H]}
    del q, k, v, bias, sq, sk, sv, smask

    # K1 with dropout and K2, at the encoder's training shape.
    B, rate = 50, 0.1
    q, k, v = (torch.randn((B, S, E), generator=gen, device="cuda")
               for _ in range(3))
    bias = make_bias("causal_padding", B, S, S, gen, neg_inf)
    seeds = make_seeds(B, gen)

    def plain_fwd():
        keep = fa.dropout_keep_mask(seeds, H, S, S, rate)
        return fa.fused_attention_reference(q, k, v, bias, H, keep, rate)

    out, stats = fa.fused_attention_fwd(q, k, v, bias, H, seeds, rate,
                                        return_stats=True)
    err = float((out - plain_fwd()).abs().max())
    check(err <= KERNEL_TOL, f"training shape, dropout: max|diff| {err:.3e}")
    kernel_ms, plain_ms = in_turns(
        plain_fwd, lambda: fa.fused_attention_fwd(q, k, v, bias, H, seeds,
                                                  rate, return_stats=True),
        f"K1 dropout {rate} q/k/v [{B},{S},{E}] H={H} f32")
    sq, sk, sv, smask = _sdpa_inputs(q, k, v, bias, H)
    with torch.no_grad():
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            sq, sk, sv, attn_mask=smask))
    fwd_flop = 4.0 * B * S * S * E
    fwd_bytes = 4.0 * (4 * B * S * E + B * S * S + 2 * B * H * S) + 4.0 * B
    b_ms, b_by = bound(fwd_flop, fwd_bytes)
    log(f"timing K1 dropout: library (SDPA fwd, no dropout) {lib_ms:.4f} "
        f"ms, bound {b_ms:.4f} ms ({b_by}), 3xTF32 bound "
        f"{tf32_bound(fwd_flop, fwd_bytes):.4f} ms")
    rows["fwd_dropout"] = {"ms": kernel_ms, "plain_ms": plain_ms,
                           "library_ms": lib_ms, "bound_ms": b_ms,
                           "bound_by": b_by,
                           "tf32_bound_ms": tf32_bound(fwd_flop, fwd_bytes),
                           "max_abs_err": err,
                           "shape": [B, S, E, H], "rate": rate}

    dout = torch.randn((B, S, E), generator=gen, device="cuda")
    got = fa.fused_attention_bwd(q, k, v, bias, dout, stats, H, seeds, rate)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    keep = fa.dropout_keep_mask(seeds, H, S, S, rate)
    plain_out = fa.fused_attention_reference(qg, kg, vg, bias, H, keep, rate)
    ref = torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                              retain_graph=True)
    diffs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    err = max(d / max(1.0, float(r.abs().max())) for d, r in zip(diffs, ref))
    check(err <= GRAD_TOL, f"training shape, K2: rel max|diff| {err:.3e}")
    again = fa.fused_attention_bwd(q, k, v, bias, dout, stats, H, seeds, rate)
    repeat = all(torch.equal(a, b) for a, b in zip(got, again))
    log(f"K2 at [{B},{S},{E}]: a second launch on the same inputs gives "
        f"equal dq, dk, dv: {repeat}")
    check(repeat, "K2: two launches on the same inputs differ")
    kernel_ms, plain_ms = in_turns(
        lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                                    retain_graph=True),
        lambda: fa.fused_attention_bwd(q, k, v, bias, dout, stats, H, seeds,
                                       rate),
        f"K2 dropout {rate} q/k/v [{B},{S},{E}] H={H} f32")
    sq, sk, sv = (t.detach().view(B, S, H, E // H).transpose(1, 2)
                  .requires_grad_() for t in (q, k, v))
    lib_out = F.scaled_dot_product_attention(sq, sk, sv,
                                             attn_mask=bias[:, None])
    lib_dout = dout.view(B, S, H, E // H).transpose(1, 2)
    lib_ms = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (sq, sk, sv), lib_dout, retain_graph=True))
    # Five [Sq,Sk,D] contractions a head (S and dO·Vᵀ rebuilt, dV, dQ,
    # dK); q, k, v, dO, bias, stats and seeds read, dq, dk, dv written.
    bwd_flop = 10.0 * B * S * S * E
    bwd_bytes = 4.0 * (7 * B * S * E + B * S * S + 2 * B * H * S) + 4.0 * B
    b_ms, b_by = bound(bwd_flop, bwd_bytes)
    log(f"timing K2: library (SDPA backward, no dropout) {lib_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}), 3xTF32 bound "
        f"{tf32_bound(bwd_flop, bwd_bytes):.4f} ms")
    rows["bwd"] = {"ms": kernel_ms, "plain_ms": plain_ms,
                   "library_ms": lib_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "tf32_bound_ms": tf32_bound(bwd_flop, bwd_bytes),
                   "max_abs_err": max(diffs), "max_rel_err": err,
                   "shape": [B, S, E, H], "rate": rate}
    rows.update(decoder_timing(fa, k, v, seeds, rate, gen, neg_inf))
    return rows


def decoder_timing(fa, k, v, seeds, rate, gen, neg_inf) -> dict:
    """K1 (dropout) and K2 at the decoder's cross attention of the fit:
    one query row over the encoder's keys k/v [B,Sk,E] with a padding
    bias, against their plain versions, in turns, with their bounds."""
    B, Sk, E = k.shape
    H, Sq = 8, 1
    q, dout = (torch.randn((B, Sq, E), generator=gen, device="cuda")
               for _ in range(2))
    bias = make_bias("causal_padding", B, Sq, Sk, gen, neg_inf)
    keep = fa.dropout_keep_mask(seeds, H, Sq, Sk, rate)
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    plain_out = fa.fused_attention_reference(qg, kg, vg, bias, H, keep, rate)
    ref = torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                              retain_graph=True)
    out, stats = fa.fused_attention_fwd(q, k, v, bias, H, seeds, rate,
                                        return_stats=True)
    got = fa.fused_attention_bwd(q, k, v, bias, dout, stats, H, seeds, rate)
    fwd_err = float((out - plain_out.detach()).abs().max())
    diffs = [float((g - r).abs().max()) for g, r in zip(got, ref)]
    bwd_err = max(d / max(1.0, float(r.abs().max()))
                  for d, r in zip(diffs, ref))
    check(fwd_err <= KERNEL_TOL and bwd_err <= GRAD_TOL,
          f"decoder shape: K1 {fwd_err:.3e}, K2 rel {bwd_err:.3e}")
    label = f"dropout {rate} q [{B},{Sq},{E}] k/v [{B},{Sk},{E}] H={H}"
    fwd_ms, fwd_plain = in_turns(
        lambda: fa.fused_attention_reference(
            q, k, v, bias, H, fa.dropout_keep_mask(seeds, H, Sq, Sk, rate),
            rate),
        lambda: fa.fused_attention_fwd(q, k, v, bias, H, seeds, rate,
                                       return_stats=True),
        f"K1 decoder cross, {label}")
    bwd_ms, bwd_plain = in_turns(
        lambda: torch.autograd.grad(plain_out, (qg, kg, vg), dout,
                                    retain_graph=True),
        lambda: fa.fused_attention_bwd(q, k, v, bias, dout, stats, H, seeds,
                                       rate),
        f"K2 decoder cross, {label}")
    rows = {}
    for name, ms, plain_ms, flop, nbytes, err in (
            ("fwd_decoder", fwd_ms, fwd_plain, 4.0 * B * Sq * Sk * E,
             4.0 * (2 * B * Sq * E + 2 * B * Sk * E + B * Sq * Sk
                    + 2 * B * H * Sq) + 4.0 * B, fwd_err),
            ("bwd_decoder", bwd_ms, bwd_plain, 10.0 * B * Sq * Sk * E,
             4.0 * (3 * B * Sq * E + 4 * B * Sk * E + B * Sq * Sk
                    + 2 * B * H * Sq) + 4.0 * B, max(diffs))):
        b_ms, b_by = bound(flop, nbytes)
        rows[name] = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": b_ms, "bound_by": b_by,
                      "tf32_bound_ms": tf32_bound(flop, nbytes),
                      "max_abs_err": err, "shape": [B, Sq, Sk, E, H],
                      "rate": rate}
        log(f"timing {name}: bound {b_ms:.4f} ms ({b_by})")
    return rows


def k3_timing(fab, neg_inf) -> dict:
    """K3, its plain version and the library call at the serving shape
    [2048,120,128] (K1's serving launch, head-split) and the training
    shape [400,120,128], each slice with the encoder's bias (the path
    phase holds K3 to its plain version at both shapes)."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(6)
    H, S, D = 8, 120, 128
    rows = {}
    for path, B in (("serving", 256), ("training", 50)):
        BH = B * H
        q, k, v = (torch.randn((BH, S, D), generator=gen, device="cuda")
                   for _ in range(3))
        bias = make_bh_bias("causal_padding", B, H, S, S, gen, neg_inf)
        kernel_ms, plain_ms = in_turns(
            lambda: fab.fused_attention_bh_reference(q, k, v, bias),
            lambda: fab.fused_attention_bh_fwd(q, k, v, bias),
            f"K3 q/k/v [{BH},{S},{D}] f32")
        with torch.no_grad():
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=bias))
        # QKᵀ and PV; q, k, v and the per-slice bias read, out written.
        b_ms, b_by = bound(4.0 * BH * S * S * D,
                           4.0 * (4 * BH * S * D + BH * S * S))
        log(f"timing K3 {path}: library (SDPA, per-slice float mask) "
            f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({b_by})")
        rows[path] = {"ms": kernel_ms, "plain_ms": plain_ms,
                      "library_ms": lib_ms, "bound_ms": b_ms,
                      "bound_by": b_by, "shape": [BH, S, D]}
        del q, k, v, bias
    return rows


def load_synth():
    spec = importlib.util.spec_from_file_location(
        "make_synth_corpus", os.path.join(ROOT, "scripts",
                                          "make_synth_corpus.py"))
    synth = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(synth)
    return synth


def slice_phase(fa, fab, tmp: str, corpus: str) -> dict:
    from sign_language_nlp_torch import predict
    from sign_language_nlp_torch.data import DatasetBuilder
    from sign_language_nlp_torch.models.registry import build_model
    from sign_language_nlp_torch.models.transformer import (
        MultiHeadAttentionBlock)
    from sign_language_nlp_torch.training.checkpoint import save_checkpoint

    ckpt = os.path.join(tmp, "ckpt")
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
    reset_counts(fa, fab)
    t0 = time.perf_counter()
    predict.main(["--checkpoint", ckpt, "--dataset_dir", corpus,
                  "--out", out_path, "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches = fa.fused_attention_fwd.launches
    k3 = fab.fused_attention_bh_fwd.launches
    check(fa.fused_attention_fwd.dropout_launches == 0
          and fa.fused_attention_bwd.launches == 0 and k3 == 0,
          "serving launched the dropout branch, K2 or K3")
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
    return {"launches": launches, "k3": k3, "logprob_err": err}


def _first_step(factory, cell_gens, state, rate, batch, backend):
    """Loss and global gradient norm of one training step of a cell
    from `state`, with its dropout generator fresh from its seed."""
    from sign_language_nlp_torch.models.transformer import (
        MultiHeadAttentionBlock)
    from sign_language_nlp_torch.ops.losses import cross_entropy_loss
    from sign_language_nlp_torch.training.optimizers import (
        clip_by_global_norm)

    _, gen = cell_gens()
    model = factory(torch.Generator().manual_seed(0))
    model.load_state_dict(state)
    model.to("cuda").train()
    for m in model.modules():
        if isinstance(m, MultiHeadAttentionBlock):
            m.backend = backend
    tok, ln, y, w = batch
    out = model(tok, ln, y, dropout_rate=rate, generator=gen)
    loss = cross_entropy_loss(out, y, ignore_index=model.tgt_pad_idx,
                              sample_weight=w)
    loss.backward()
    norm = clip_by_global_norm([p.grad for p in model.parameters()], 0.5)
    torch.cuda.synchronize()
    return float(loss.detach()), float(norm)


def kind_of(name: str) -> str:
    for kind, pattern in KINDS:
        if re.search(pattern, name, re.IGNORECASE):
            return kind
    return "other"


def _device_events(trainer, data, task) -> list:
    """The device events (kernels, memcpys, memsets) of one fit, from
    torch.profiler's CUDA trace."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        trainer.fit(data, task)
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")
            and "dur" in e]


def training_profile(trainer, data, task, per_step: int) -> dict:
    """Device time per train step by kind of kernel, and the device's
    busy share, inside one profiled one-cell fit of `task` (a fit of it
    first warms up). The window is PROFILE_STEPS whole steady steps:
    from the K1 launch that opens the attention of step PROFILE_SKIP to
    the one PROFILE_STEPS steps later, found as every `per_step`-th K1
    launch (the eval batch's come after every train step). Kernels are
    summed by kind; memcpy and memset apart; busy is the union of device
    intervals in the window over its length."""
    trainer.fit(data, task)
    torch.cuda.synchronize()
    dev = _device_events(trainer, data, task)
    marks = sorted(e["ts"] for e in dev if e["cat"] == "kernel"
                   and re.search(STEP_MARK, e["name"]))
    need = per_step * (PROFILE_SKIP + PROFILE_STEPS) + 1
    check(len(marks) >= need, f"profile: {len(marks)} K1 launches in the "
          f"trace, want at least {need}")
    t0 = marks[per_step * PROFILE_SKIP]
    t1 = marks[per_step * (PROFILE_SKIP + PROFILE_STEPS)]
    inside = [e for e in dev if t0 <= e["ts"] < t1]
    kinds = collections.Counter()
    copies = collections.Counter()
    for e in inside:
        if e["cat"] == "kernel":
            kinds[kind_of(e["name"])] += e["dur"] / 1e3 / PROFILE_STEPS
        else:
            copies[e["cat"]] += e["dur"] / 1e3 / PROFILE_STEPS
    spans = sorted((e["ts"], min(e["ts"] + e["dur"], t1)) for e in inside)
    busy, (lo0, hi0) = 0.0, spans[0]
    for lo, hi in spans[1:]:
        if lo > hi0:
            busy, lo0, hi0 = busy + hi0 - lo0, lo, hi
        else:
            hi0 = max(hi0, hi)
    busy += hi0 - lo0
    busy_share = busy / (t1 - t0)
    step_span = (t1 - t0) / 1e3 / PROFILE_STEPS
    total = sum(kinds.values())
    log(f"training profile: {total:.3f} ms of kernels per train step of one "
        f"cell (steps {PROFILE_SKIP}-{PROFILE_SKIP + PROFILE_STEPS} of one "
        f"fit), device busy {100 * busy_share:.1f}% of the {step_span:.3f} "
        f"ms per step; memcpy {copies['gpu_memcpy']:.3f}, memset "
        f"{copies['gpu_memset']:.3f} ms/step")
    for kind, ms in kinds.most_common():
        log(f"training profile: {kind:34s} {ms:8.3f} ms/step "
            f"{100 * ms / total:5.1f}%")
    check(0.0 < busy_share <= 1.0, f"profile: busy share {busy_share:.4f} "
          "outside (0, 1]")
    return {"ms_per_step": total, "busy_share": busy_share,
            "span_ms_per_step": step_span, "kinds": dict(kinds),
            "copies_ms_per_step": dict(copies)}


def training_setup(corpus: str):
    """The corpus as the trainer takes it, its monitor split, the target
    vocabulary and a factory of full-width Transformers, from whatever
    `sign_language_nlp_torch` is first on sys.path."""
    from sign_language_nlp_torch.data import AslDataset
    from sign_language_nlp_torch.models.registry import build_model
    from sign_language_nlp_torch.search.kfold import train_valid_split

    ds = AslDataset.build({"dataset_dir": corpus, "fields": FIELDS,
                           "samples_min_freq": 2})
    src_v, tgt_v = ds.src_vocab, ds.tgt_vocab
    train_rows, valid_rows = train_valid_split(ds.labels_idx, 5)

    def factory(gen):
        return build_model("model.Transformer", len(src_v), len(tgt_v),
                           src_v.pad_index, tgt_v.pad_index,
                           model_args=FULL_WIDTH, generator=gen)

    return ((ds.tokens, ds.lengths, ds.labels_idx), train_rows, valid_rows,
            tgt_v, len(src_v), factory)


def profile_cell(data, train_rows, valid_rows, tgt_v, factory) -> dict:
    """`training_profile` of one cell (the first of CELLS) with the grid's
    training settings, over PROFILE_SKIP + PROFILE_STEPS + 2 train steps
    and one eval batch."""
    from sign_language_nlp_torch.training.engine import (PopulationTrainer,
                                                         TrainConfig,
                                                         TrainTask)

    cfg = TrainConfig(max_epochs=1, verbose=0, device="cuda",
                      **TRAIN_SETTINGS)
    n = (PROFILE_SKIP + PROFILE_STEPS + 2) * cfg.batch_size
    task = TrainTask(train_rows=[train_rows[:n]], valid_rows=[valid_rows[:50]],
                     lr=np.float32([CELLS[0][0]]),
                     dropout=np.float32([CELLS[0][1]]))
    trainer = PopulationTrainer(factory, tgt_v.pad_index, len(tgt_v), cfg)
    return training_profile(trainer, data, task,
                            3 * FULL_WIDTH["num_layers"])


def training_phase(fa, fab, corpus: str) -> dict:
    from sign_language_nlp_torch.training.engine import (PopulationTrainer,
                                                         TrainConfig,
                                                         TrainTask,
                                                         cell_generators)

    data, train_rows, valid_rows, tgt_v, n_src, factory = training_setup(
        corpus)
    P = len(CELLS)
    cfg = TrainConfig(max_epochs=2, verbose=2, device="cuda",
                      **TRAIN_SETTINGS)
    task = TrainTask(train_rows=[train_rows] * P, valid_rows=[valid_rows] * P,
                     lr=np.asarray([c[0] for c in CELLS], np.float32),
                     dropout=np.asarray([c[1] for c in CELLS], np.float32))
    trainer = PopulationTrainer(factory, tgt_v.pad_index, len(tgt_v), cfg)
    log(f"training: {len(train_rows)} train / {len(valid_rows)} valid rows, "
        f"S {data[0].shape[1]}, {P} cells {CELLS} (lr, dropout), "
        f"src vocab {n_src}, classes {len(tgt_v)}")

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(fa, fab)
    t0 = time.perf_counter()
    out = trainer.fit(data, task)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    k1 = fa.fused_attention_fwd.launches
    k1_drop = fa.fused_attention_fwd.dropout_launches
    k2 = fa.fused_attention_bwd.launches
    k3 = fab.fused_attention_bh_fwd.launches
    peak = torch.cuda.max_memory_allocated()

    hist = out["history"]
    steps, evals = out["steps"], out["eval_batches"]
    per = 3 * FULL_WIDTH["num_layers"]
    log(f"training: fit {wall:.3f} s, {steps} train steps "
        f"({steps / wall:.2f} steps/s over the fit, valid passes "
        f"included), {evals} eval batches; peak memory "
        f"{peak / 2 ** 30:.2f} GiB; launches K1 {k1} (dropout {k1_drop}), "
        f"K2 {k2}, K3 {k3}")
    for key in ("train_loss", "valid_loss", "valid_accuracy",
                "valid_neg_log_loss", "lr"):
        log(f"training: {key} by epoch x cell {hist[key].tolist()}")
    check(all(v.shape == (2, P) for v in hist.values()),
          f"history shapes {[v.shape for v in hist.values()]}")
    check(all(np.isfinite(v).all() for k, v in hist.items()
              if v.dtype != bool), "non-finite history")
    check(list(out["epochs_run"]) == [2] * P, f"epochs {out['epochs_run']}")
    check(k1 == per * (steps + evals) and k1_drop == per * steps
          and k2 == per * steps and k3 == 0,
          f"launches K1 {k1} (dropout {k1_drop}), K2 {k2} for {steps} "
          f"steps and {evals} eval batches")

    # One first step of each cell, kernels vs plain path, from the same
    # weights and dropout seeds.
    first = train_rows[:cfg.batch_size]
    batch = tuple(torch.as_tensor(a[first], dtype=torch.int64,
                                  device="cuda") for a in data)
    batch = batch + (torch.ones(len(first), device="cuda"),)
    worst_loss, worst_norm = 0.0, 0.0
    for c, (lr, rate) in enumerate(CELLS):
        def gens(c=c):
            return cell_generators(cfg.seed, c, torch.device("cuda"))
        state = factory(gens()[0]).state_dict()
        lk, nk = _first_step(factory, gens, state, rate, batch, "auto")
        lp, np_ = _first_step(factory, gens, state, rate, batch, "xla")
        worst_loss = max(worst_loss, abs(lk - lp))
        worst_norm = max(worst_norm, abs(nk - np_) / np_)
        log(f"training: first step cell {c} (lr {lr}, dropout {rate}): "
            f"loss kernels {lk:.6f} plain {lp:.6f}, grad norm kernels "
            f"{nk:.6f} plain {np_:.6f}")
    check(worst_loss <= STEP_LOSS_TOL, f"first-step losses differ by "
          f"{worst_loss:.3e}")
    check(worst_norm <= STEP_NORM_RTOL, f"first-step grad norms differ by "
          f"{worst_norm:.3e} relative")
    profile = profile_cell(data, train_rows, valid_rows, tgt_v, factory)
    return {"k1": k1, "k1_dropout": k1_drop, "k2": k2, "k3": k3,
            "steps": steps,
            "eval_batches": evals, "wall_s": wall, "peak_bytes": peak,
            "profile": profile,
            "first_step_loss_err": worst_loss,
            "first_step_norm_rel_err": worst_norm}


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
    from sign_language_nlp_torch.ops import fused_attention_bh as fab
    from sign_language_nlp_torch.ops.attention import NEG_INF

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    build_phase(build)
    worst = kernel_phase(fa, NEG_INF)
    worst_drop = dropout_phase(fa, NEG_INF)
    worst_grad_abs, worst_grad_rel = backward_phase(fa, NEG_INF)
    worst_k3 = k3_phase(fab, NEG_INF)
    k3_path = k3_path_phase(fa, fab, NEG_INF)
    times = timing_phase(fa, NEG_INF)
    k3_times = k3_timing(fab, NEG_INF)
    log(f"timing K3 serving {k3_times['serving']['ms']:.4f} ms beside K1 "
        f"{times['fwd']['ms']:.4f} ms on the same arithmetic (K1's serving "
        "launch in model layout)")
    with tempfile.TemporaryDirectory() as tmp:
        corpus = os.path.join(tmp, "corpus")
        load_synth().make_corpus(corpus, n_classes=100, n_samples=2000,
                                 seed=1)
        serving = slice_phase(fa, fab, tmp, corpus)
        training = training_phase(fa, fab, corpus)

    def entry(name, source, replaces, launches, row, err):
        return {"name": name, "route": "cuda",
                "source": f"sign_language_nlp_torch/csrc/{source}",
                "replaces": f"sign_language_nlp_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err,
                **{k: row[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms", "shape",
                                       "tf32_bound_ms") if k in row}}

    log(json.dumps({"training": training}))
    log(json.dumps({"kernels": [
        {**entry("fused_attention_fwd", "fused_attention_fwd.cu",
                 "pallas_attention_train.py:111",
                 serving["launches"] + training["k1"]
                 - training["k1_dropout"], times["fwd"],
                 max(worst, times["fwd"]["max_abs_err"])),
         "launches_by_path": {"serving": serving["launches"],
                              "training": training["k1"]
                              - training["k1_dropout"]}},
        {**entry("fused_attention_fwd (dropout)", "fused_attention_fwd.cu",
                 "pallas_attention_train.py:111", training["k1_dropout"],
                 times["fwd_dropout"],
                 max(worst_drop, times["fwd_dropout"]["max_abs_err"])),
         "launches_by_path": {"training": training["k1_dropout"]},
         "rate": times["fwd_dropout"]["rate"],
         "decoder": times["fwd_decoder"]},
        {**entry("fused_attention_bwd", "fused_attention_bwd.cu",
                 "pallas_attention_train.py:139", training["k2"],
                 times["bwd"],
                 max(worst_grad_abs, times["bwd"]["max_abs_err"])),
         "launches_by_path": {"training": training["k2"]},
         "rate": times["bwd"]["rate"],
         "max_rel_err": max(worst_grad_rel, times["bwd"]["max_rel_err"]),
         "decoder": times["bwd_decoder"]},
        {**entry("fused_attention_bh", "fused_attention_bh.cu",
                 "pallas_attention.py:36",
                 serving["k3"] + training["k3"] + k3_path["launches"],
                 k3_times["serving"],
                 max(worst_k3, k3_path["max_abs_err"])),
         "launches_by_path": {"serving": serving["k3"],
                              "training": training["k3"],
                              "op": k3_path["launches"]},
         "k1_ms": times["fwd"]["ms"], "training_shape": k3_times["training"],
         "grad_max_rel_err": k3_path["grad_rel_err"],
         "loss_rel_err": k3_path["loss_rel_err"]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
