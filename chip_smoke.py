#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout. Phases:

1. the card: ``nvidia-smi`` name and power limit;
2. build every kernel of the port from ``distributeddeeplearning_tpu_torch/
   csrc`` (one ``nvcc`` per source, all started together), timed, with
   the registers and spills from ptxas of the tensor-core kernels (the
   flash forward's and backward's, the bf16 1x1 forward's, dx's and dw's
   and 3x3 forward's, dx's and dw's);
3. the flash forward against its plain PyTorch version on the card over a
   grid of shapes, with its device time (CUDA-graph replay, no host launch
   work), its eager per-call time, the plain version's and the one-call
   library yardstick's device times, and the roofline bound;
4. the sampling path: GPT-2 small at full width in float32, seeded weights
   written as a flax-layout ``.npz``, 4 prompts x 128 tokens, 32 greedy new
   tokens through ``python -m distributeddeeplearning_tpu_torch.generate
   --attn flash``; the kernel counts must show 12 layers x 32 steps of
   forward launches, the logits must agree with the dense impl, and the
   KV-cache path is run too; tokens/s and a device-time profile of one step;
5. TinyLlama-1.1B widths at 2 layers through the kernel, against dense;
6. the backward and dropout grid: the dq and dk/dv kernels against the plain
   backward, and the forward with dropout against its plain version, over S
   in {160, 1024, 4096} x D in {64, 128} x {f32, bf16} x {causal, full} x
   rate in {0, 0.1}, timed beside their bounds and, at rate 0, the backward
   of ``scaled_dot_product_attention`` (device time, and eager);
7. the training path's kernel rows, at its shape (B=16, S=1024, H=12, D=64,
   bf16, causal, rate 0.1; each kernel at rate 0 too, beside the library
   yardstick there), and the forward, dq and dk/dv kernels run twice there
   in bf16 and f32, which must repeat bit for bit;
8. the training path: ``python -m distributeddeeplearning_tpu_torch.train
   --model gpt2_small --batch-size 16 --seq-len 1024 --attn flash
   --synthetic`` for a few steps (bf16 compute, f32 masters, dropout 0.1);
   each kernel must be launched 12 x steps times, every loss finite and the
   first near ln(vocab); tokens/s and a device-time profile of one step;
9. one training step at full width in f32 through flash and through dense
   on the same batch and dropout seeds: loss and every gradient must agree;
10. the BatchNorm kernel grid: kernels #4-#7 against their plain versions
   at the 16 (M, C, relu, residual) variants of ResNet-50's 53 BatchNorm
   layers at batch 512 (12 distinct shapes), in bf16 and f32, with device
   times, bounds, the plain versions' times and ``F.batch_norm``'s forward
   and backward as the library yardstick; #4 and #6 run twice and must
   repeat bit for bit;
11. the ResNet training path: ``python -m distributeddeeplearning_tpu_torch.
   train --model resnet50 --batch-size 512 --synthetic --fused-bn`` for a
   few steps (224x224, 1000 classes, bf16 compute, f32 masters, the JAX
   default sgd); each BatchNorm kernel must be launched 53 x steps times,
   every loss finite and the first near ln(1000); images/s, peak memory and
   a device-time profile of one step;
12. one f32 step of ResNet-50 at batch 32 with ``fused_bn`` on and off, same
   weights and batch: loss, every gradient and every running buffer must
   agree;
13. the matmul+BatchNorm kernel grid: kernels #8-#10 against their plain
   versions at the 16 (M, K, N, bn) variants of ResNet-50's 36 bottleneck
   1x1 convolutions at batch 512 and one with the prologue but no ReLU, in
   bf16 and f32, with device times, bounds, the plain versions' times and
   ``torch.matmul`` of the bare product as the library yardstick; the sums
   of #8 and #9 and the whole of #10 run twice and must repeat bit for bit,
   each dw check must fail a dw that lacks one of #10's chunks of M, and
   each check of #8's and #9's sums must fail sums that lack one block's
   run of pixels;
14. the ``--fused-block`` training path: ``python -m
   distributeddeeplearning_tpu_torch.train --model resnet50 --batch-size
   512 --synthetic --fused-block`` for a few steps; each matmul kernel must
   be launched 36 x steps times and no other kernel of the port, every loss
   finite and the first near ln(1000); images/s, peak memory and a
   device-time profile of one step, and beside it, for the record, the
   profile of one step of the unfused path;
15. the 3x3 conv+BatchNorm kernel grid: kernels #11-#13 against their
   plain versions at the four (H = W, C) shapes of ResNet-50's 13 stride-1
   3x3 convolutions at batch 512, with the prologue and ReLU, and one small
   row without the prologue, in bf16 and f32, with device times, bounds,
   the plain versions' times and cuDNN (``F.conv2d``,
   ``torch.nn.grad.conv2d_input`` and ``conv2d_weight`` of the bare
   convolution) as the library yardstick; the sums of #11 and #12 and the
   whole of #13 run twice and must repeat bit for bit, each dw check
   must fail a dw that lacks one of #13's chunks of M, and each check of
   #11's and #12's sums must fail sums that lack one block's run of
   pixels;
16. the ``--fused-block --fused-conv3`` training path, as phase 14: each
   matmul kernel launched 36 x steps times, each 3x3 kernel 13 x steps
   times, no other kernel of the port;
17. one f32 step of ResNet-50 at batch 32 with ``fused_block``, with
   ``fused_block`` and ``fused_conv3``, and with neither, same weights and
   batch, held as phase 12 (one f64 step serves both).

Each phase prints its wall seconds. It prints a ``{"kernels": [...]}`` line
and, last, ``{"ok": true, "device": {...}}``. Any failed phase exits
non-zero without that last line, and so does a machine without a card.

    python3 chip_smoke.py --step-ab CHECKOUT [OTHER]

runs none of that: it times, with the port of CHECKOUT and of OTHER (by
default this checkout), one step of the GPT-2 training path with the flash
kernels' device times (#1-#3 at two shapes, and SDPA's forward beside
#1), and one bf16 step of ResNet-50 ``--fused-block --fused-conv3`` at
batch 512 (wall, busy, the conv_bn and linear_bn classes, images/s, peak
memory) with the device times of #11-#13 at the four stride-1 3x3 shapes
(bf16 and f32), of #8-#10 at stage 1's conv3 and over one step's 36
layers; each checkout and each of the two in a process of its own, in
turns (CHECKOUT, OTHER, OTHER, CHECKOUT), for a before/after comparison on
one card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s and FLOP/s by the
# operand type the kernel computes in. The kernel's f32 products run on the
# CUDA cores (67 TFLOP/s), its bf16 bound is taken at the tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
# Kernel vs plain version on the same inputs, for each output row (one
# query position of one head): |o - ref| <= atol + rtol * max|ref row|. f32
# differs only in summation order. A bf16 output is rounded to 8 significant
# bits, so it may differ by one ulp of the row's largest value, at most
# 2^-7 of it; rtol allows two. Its atol only keeps the limit of a fully
# masked row, whose output is exactly 0, above 0.
TOL = {"float32": (1e-4, 0.0), "bfloat16": (1e-6, 2 ** -6)}
TOL_LSE = 1e-3
# Backward kernels vs plain version, per output row (one query or key
# position of one head), as (atol, rtol) of TOL: |g - ref| <= atol + rtol *
# max|ref row|, fixed before the first run of this grid. f32 differs in
# summation order. bf16 rounds ds and p_drop to bf16 from f32 values summed
# in another order, and rounds the gradient once at the end. atol covers
# rows that are zero in exact arithmetic (a causal first query: ds = 0),
# where both sides hold f32 rounding noise: up to 1.5e-6 in the card tests.
TOL_GRAD = {"float32": (1e-5, 1e-4), "bfloat16": (1e-5, 2 ** -5)}
# Each timing runs its function for at least this long in all.
MIN_TOTAL_MS = 30.0
# Main path: GPT-2 small sampling.
PROMPTS, PROMPT_LEN, NEW_TOKENS = 4, 128, 32
# flash vs dense logits on the same sequences (f32, different summation).
LOGIT_TOL = 1e-3
# An emitted greedy token's dense logit may sit this far below the dense
# maximum (ties and near-ties between the impls).
ARGMAX_TOL = 1e-4
# Training path: GPT-2 small, batch 16 x 1024, bf16 compute, dropout 0.1.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 16, 1024, 6
VOCAB = 50257
# The first loss sits near ln(vocab): random init, tied head logits with a
# std of about 0.55, adding about 0.15.
FIRST_LOSS_TOL = 0.5
# Flash vs dense, one f32 training step of GPT-2 small at batch 4 x 1024:
# the loss, and each gradient relative to max(its largest |ref|, 1e-4 of
# the largest of all; the key bias gradient is zero in exact arithmetic).
DENSE_BATCH = 4
STEP_LOSS_TOL = 1e-4
STEP_GRAD_TOL = 1e-3
# BatchNorm kernels vs plain versions, per channel column, fixed before the
# first run of the grid. The elementwise outputs (#5 y, #7 dx and dres)
# compute the same f32 formula in the same order: f32 within 1e-5 of the
# column's largest |ref|; a bf16 output is rounded once and may sit one ulp
# away, 2^-7 of that. The reductions (#4 mean and var, #6 dbeta and dgamma)
# sum the same f32 terms in another order: within 1e-5 of the column's sum
# of |terms| (mean: of |x| / M; var: of 2 x^2 / M).
BN_ROW_TOL = {"float32": 1e-5, "bfloat16": 2 ** -7}
BN_SUM_TOL = 1e-5
BN_EPS = 1e-5
# ResNet training path: ResNet-50 at batch 512, 224x224, 1000 classes.
RESNET_BATCH, RESNET_IMAGE, RESNET_CLASSES, RESNET_STEPS = 512, 224, 1000, 6
RESNET_BN_LAYERS = 53  # the stem, 16 blocks x 3, 4 downsample BatchNorms
# The first loss sits near ln(1000) = 6.908: a CPU forward of the port's
# seeded ResNet-50 (batch 16) gave logits with a std of 0.41 (adding about
# 0.08) and losses 6.84 and 7.05 on two batches.
RESNET_FIRST_LOSS_TOL = 0.3
# Fused vs unfused, one f32 ResNet-50 step at batch 32 (TF32 off): the loss
# within 1e-4 and each running buffer within 1e-5 of max(its largest |ref|,
# 1). The gradients are held to the same step in float64 (unfused), each
# relative to max(its largest |ref|, 1e-4 of the largest of all): the fused
# f32 step's worst tensor, and its error over all gradients in the 2-norm,
# may be at most FUSED_GRAD_FACTOR times the unfused f32 step's. The
# unfused f32 step sits far from exact arithmetic: at this seed 3.3e-2 off
# in its worst tensor and 5.7e-4 in the 2-norm (this phase on an H100,
# PERF.md), and the JAX package's f32 step is as far from its f64 step on
# the CPU (tests/test_torch_grad_gap.py). The cause is its BatchNorm
# statistics summed in f32 and differenced as E[x^2] - mean^2. So two f32
# orders of summation cannot agree within 1e-3 a tensor; each is held
# against the f64 step instead. The --fused-block step takes the
# statistics of its 1x1 convolutions in double and reads 9.8e-5 (worst)
# and 4.3e-6 (2-norm) on an H100: it is held to the f64 step directly,
# within FUSED_BLOCK_GRAD_WORST and FUSED_BLOCK_GRAD_NORM, and so is the
# step with --fused-conv3 too, whose 3x3 kernels take bn2's statistics in
# double as well.
FUSED_BATCH = 32
FUSED_LOSS_TOL = 1e-4
FUSED_GRAD_FACTOR = 2.0
FUSED_BLOCK_GRAD_WORST = 1e-3
FUSED_BLOCK_GRAD_NORM = 1e-4
FUSED_BUFFER_TOL = 1e-5
# Matmul+BatchNorm kernels vs plain versions. The products (y, dx, dw) per
# element within FLBN_PROD_TOL of the largest |ref| of the element's column,
# as the BatchNorm grid holds its outputs; a bf16 output may sit one more
# ulp of itself away. On an H100 the f32 grid's errors reach 4.1e-6 of
# that column maximum, while a dw that lacks one of its chunks of M is off
# by at least 2.5e-3 of it (the grid checks that the limit sees it). The
# column sums (#8's sum(y) and sum(y^2), #9's dbeta and dgamma) within
# 1e-5 of their sum of |terms|; #8's are over y as stored, so where a bf16
# y rounded the other way they also carry that difference exactly (the
# column's sum of |y - y_ref| and of |y^2 - y_ref^2|).
FLBN_PROD_TOL = 1e-5
FLBN_SUM_TOL = 1e-5
RESNET_LINEAR_LAYERS = 36  # 16 blocks x (conv1, conv3), 4 downsamples
# The 3x3 conv+BatchNorm kernels are held as the matmul kernels are: y and
# dx per element of their (pixels, channels) view, dw of its (Cout, 9 *
# Cin) view, within FLBN_PROD_TOL of their column's largest |ref| (a bf16
# output one more ulp), the sums within FLBN_SUM_TOL of their sum of
# |terms|.
RESNET_CONV3_LAYERS = 13  # the 3x3s of the 13 stride-1 bottlenecks


def log(msg: str) -> None:
    print(msg, flush=True)


def _events_ms(run, n: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def call_ms(fn) -> float:
    """Mean time of one eager call of ``fn`` by CUDA events over back-to-back
    calls after a warm-up: what a caller pays, host launch work included
    when it exceeds the device work."""
    import torch

    fn()
    torch.cuda.synchronize()
    n = int(min(200, max(3, MIN_TOTAL_MS / max(_events_ms(fn, 1), 1e-3))))
    return _events_ms(fn, n)


def device_ms(fn) -> float:
    """Mean device time of one call of ``fn``: calls captured in a CUDA
    graph and replayed, so no host launch work sits between them."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs want
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    per_call = max(_events_ms(fn, 1), 1e-3)
    reps = int(min(50, max(1, MIN_TOTAL_MS / per_call)))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    replays = int(min(20, max(2, MIN_TOTAL_MS / (per_call * reps))))
    ms = _events_ms(graph.replay, replays) / reps
    del graph
    return ms


def kernels_ms(fn, n: int = 5) -> float:
    """Mean device time of one call of ``fn``: the durations of the kernels
    it launches, from torch.profiler's records of ``n`` calls after a
    warm-up. For calls a CUDA graph cannot capture here, such as autograd's
    backward of a tensor made outside the capture."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if not us:
        raise RuntimeError("the profiler recorded no kernels")
    return us / n / 1e3


# Products per live (query, key) pair: the forward's s = q.k and p.v; dq's
# s, dp = do.v and ds.k; dk/dv's s, dp, p_drop^T.do and ds^T.q.
PRODUCTS = {"fwd": 2, "dq": 3, "dkv": 4}


def flash_bound(mask: np.ndarray, h: int, d: int, causal: bool,
                dtype: str, kind: str = "fwd") -> tuple[float, str]:
    """The least time of a flash kernel (``kind`` fwd, dq or dkv) on these
    inputs. Bytes over HBM: q (and, backward, do) read for the batch rows
    that keep any key, k and v read only for the keys the mask keeps, the
    mask read, the (B, S, H, D) outputs written and the f32 row vectors (lse
    written; lse and delta read backward), each once. Operations at the
    dtype's peak: 2*D FLOPs per product for every (query, key) pair the data
    needs (keys the mask keeps, under the diagonal when causal). Returns
    (ms, bound_by)."""
    b, s = mask.shape
    keep = mask != 0
    row = h * d * (4 if dtype == "float32" else 2)  # one position's q/k/v/o
    q_like, outs, vecs = {"fwd": (1, 1, 1), "dq": (2, 1, 2),
                          "dkv": (2, 2, 2)}[kind]
    nbytes = (q_like * int(keep.any(axis=1).sum()) * s * row   # q (do)
              + 2 * int(keep.sum()) * row                      # k, v
              + outs * b * s * row                             # o / grads
              + mask.size * 4 + vecs * b * h * s * 4)          # mask, lse..
    if causal:
        pairs = int((keep * (s - np.arange(s))[None, :]).sum())
    else:
        pairs = int(keep.sum()) * s
    flops = 2 * d * PRODUCTS[kind] * h * pairs
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def row_error(out, ref, atol: float, rtol: float) -> tuple[float, float]:
    """(max abs error, largest error as a share of its row's limit atol +
    rtol * max|ref row|); a share <= 1 passes."""
    diff = (out.float() - ref.float()).abs()
    limit = atol + rtol * ref.float().abs().amax(dim=-1, keepdim=True)
    return diff.max().item(), (diff / limit).max().item()


def reset_counts(kernels) -> None:
    for k in kernels:
        setattr(k["module"], k["counter"], 0)


def read_counts(kernels) -> dict:
    return {k["name"]: getattr(k["module"], k["counter"]) for k in kernels}


def phase_card() -> None:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    log(out[0])


def phase_build(kernels) -> None:
    from distributeddeeplearning_tpu_torch.ops import _build

    t0 = time.perf_counter()
    sources = sorted({k["build"] for k in kernels})
    paths = _build.build(sources)
    for source in sources:
        _build.load_library(source)
    log(f"# build: {len(paths)} source(s) in "
        f"{time.perf_counter() - t0:.2f} s -> "
        f"{', '.join(p.name for p in paths.values())}")
    for source in sources:
        report = ptxas_report(_build.build_log(paths[source]).read_text())
        if report:
            log(f"# ptxas {source}: " + json.dumps(report))


def ptxas_key(mangled: str) -> str | None:
    """The report's name of a kernel instance: the flash backward's and
    the tensor-core forward's as name<D,dropout>, the bf16 tensor-core
    BatchNorm kernels' as name<template arguments> (the 3x3 forward's MT,
    NB, resident weights; the 3x3 dx's NB, resident weights; the 1x1 dw's
    KW, NW); None for the others."""
    import re

    k = re.search(r"(flash_(?:dq|dkv|fwd_tc)(?:_tc)?_kernel)ILi(\d+)E"
                  r"(?:Li\d+E)*Lb([01])E", mangled)
    if k:
        return f"{k.group(1)}<{k.group(2)},{k.group(3)}>"
    k = re.search(r"((?:fcbn|flbn)_\w+?_tc_kernel)(?:I((?:L[a-z]\d+E)+)E)?",
                  mangled)
    if k:
        args = re.findall(r"L[a-z](\d+)E", k.group(2) or "")
        return k.group(1) + (f"<{','.join(args)}>" if args else "")
    return None


def ptxas_report(text: str) -> dict:
    """Registers and spill bytes of each kernel instance ``ptxas_key``
    names, from nvcc's ``-Xptxas -v`` output."""
    import re

    out: dict[str, dict] = {}
    name = None
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name = ptxas_key(m.group(1))
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out.setdefault(name, {}).update(spill_stores=int(m.group(1)),
                                            spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def flash_case(fa, s, b, h, d, dtype, causal, lengths, seed):
    """One grid row: the kernel vs its plain version, timed, with its bound
    and the library yardstick. Returns the row as a dict."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn((b, s, h, d), generator=gen, device=dev).to(tdt)
               for _ in range(3))
    mask_np = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        mask_np[i, :n] = 1
    mask = torch.from_numpy(mask_np).to(dev)

    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal)
    torch.cuda.synchronize()
    ref_o, ref_lse = fa.flash_attention_reference(q, k, v, mask, causal)
    diff = (o.float() - ref_o.float()).abs()
    atol, rtol = TOL[dtype]
    row_max = ref_o.float().abs().amax(dim=-1, keepdim=True)
    # The largest error as a share of its row's limit: <= 1 passes.
    err_over_tol = (diff / (atol + rtol * row_max)).max().item()
    err = diff.max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    finite = bool(torch.isfinite(o.float()).all() and torch.isfinite(lse)
                  .all())

    keep = mask.bool()[:, None, None, :]
    if causal:
        keep = keep & torch.ones((s, s), dtype=torch.bool, device=dev).tril()
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    row = {
        "s": s, "b": b, "h": h, "d": d, "dtype": dtype, "causal": causal,
        "lengths": list(lengths), "max_abs_err": err,
        "err_over_tol": err_over_tol, "lse_err": err_lse,
        "ok": finite and err_over_tol <= 1.0 and err_lse <= TOL_LSE,
    }
    def kernel():
        return fa.flash_attention_fwd(q, k, v, mask, causal=causal)

    row["ms"] = device_ms(kernel)
    row["call_ms"] = call_ms(kernel)
    row["plain_ms"] = device_ms(lambda: fa.flash_attention_reference(
        q, k, v, mask, causal))
    row["library_ms"] = device_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=keep))
    row["bound_ms"], row["bound_by"] = flash_bound(mask_np, h, d, causal,
                                                   dtype)
    return row


def phase_flash_grid(fa, failures):
    """The flash kernel against its plain version over S in {160, 1000,
    1024, 4096} x D in {64, 128} x {f32, bf16} x {causal, not}, with ragged
    masks, plus the main path's own shape first. Returns the main-path
    row."""
    rng = np.random.default_rng(SEED)
    # The sampling run's shape: 4 prompts, S = 128 + 32, 12 heads of 64,
    # f32, causal, every row live up to the same step (here mid-run).
    main = flash_case(fa, 160, PROMPTS, 12, 64, "float32", True,
                      [144] * PROMPTS, SEED)
    rows = [main]
    for d, h in ((64, 12), (128, 32)):
        for s, b in ((160, 4), (1000, 2), (1024, 2), (4096, 1)):
            # Row 0 full, the others ragged; at S=1000 one row is fully
            # masked (zero output, lse 0).
            lengths = [s] + [int(n) for n in rng.integers(s // 2, s, b - 1)]
            if s == 1000:
                lengths[-1] = 0
            for dtype in ("float32", "bfloat16"):
                for causal in (True, False):
                    rows.append(flash_case(fa, s, b, h, d, dtype, causal,
                                           lengths, int(rng.integers(1e6))))
    for r in rows:
        log("# flash_attention_fwd " + json.dumps(r))
        if not r["ok"]:
            failures.append(f"flash_attention_fwd disagrees with its plain "
                            f"version: {r}")
    return main


def seeded_flax_params(model_name: str, seed: int, **kw) -> dict:
    """Flax-layout float32 params for a registry model, drawn from a seed
    with the JAX model's initializer scales (N(0, 0.02) matrices, N(0,
    0.01) GPT positions, unit norm scales, zero biases)."""
    import torch

    from distributeddeeplearning_tpu_torch.models import model_spec
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_to_flax)

    with torch.device("meta"):
        shapes = model_spec(model_name).build(dtype=torch.float32,
                                              **kw).state_dict()
    rng = np.random.default_rng(seed)
    state = {}
    for key, t in shapes.items():
        shape = tuple(t.shape)
        if key.endswith("bias"):
            arr = np.zeros(shape, np.float32)
        elif len(shape) == 1:
            arr = np.ones(shape, np.float32)
        else:
            std = 0.01 if key == "wpe" else 0.02
            arr = rng.standard_normal(shape, dtype=np.float32) * std
        state[key] = torch.from_numpy(arr)
    return params_to_flax(state)


def run_cli(argv) -> list[list[int]]:
    from distributeddeeplearning_tpu_torch import generate as gen_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = gen_cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"generate CLI exited {rc}")
    return [json.loads(line)["tokens"]
            for line in buf.getvalue().splitlines()]


def near_argmax_failures(tokens, logits, start: int) -> int:
    """How many emitted tokens sit more than ARGMAX_TOL below the maximum
    of the logits that predicted them."""
    import torch

    ids = torch.as_tensor(tokens, device=logits.device)
    pred = logits[:, start - 1:-1]                       # (B, new, V)
    chosen = pred.gather(-1, ids[:, start:, None])[..., 0]
    return int((chosen < pred.max(dim=-1).values - ARGMAX_TOL).sum())


def phase_gpt2(kernels, failures, scratch: Path) -> dict:
    """The main path: GPT-2 small sampling with the flash kernel."""
    import torch

    from distributeddeeplearning_tpu_torch import generate as gen_cli
    from distributeddeeplearning_tpu_torch.models.generate import generate

    total = PROMPT_LEN + NEW_TOKENS
    t0 = time.perf_counter()
    npz = scratch / "gpt2_small.npz"
    np.savez(npz, **seeded_flax_params("gpt2_small", SEED))
    prompts = np.random.default_rng(SEED + 1).integers(
        0, 50257, (PROMPTS, PROMPT_LEN))
    argv = ["--model", "gpt2_small", "--params", str(npz),
            "--max-new-tokens", str(NEW_TOKENS), "--attn", "flash"]
    for row in prompts:
        argv += ["--prompt-ids", ",".join(map(str, row))]
    log(f"# gpt2_small: params written in {time.perf_counter() - t0:.2f} s")

    reset_counts(kernels)
    t0 = time.perf_counter()
    tokens = run_cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    # Sampling runs the forward kernel only.
    expected = {k["name"]: 0 for k in kernels}
    expected["flash_attention_fwd"] = 12 * NEW_TOKENS
    log(f"# gpt2_small --attn flash: CLI {cli_s:.2f} s (load + sample), "
        f"launches {launches}, expected {expected}")
    if launches != expected:
        failures.append(f"sampling path launches {launches}, expected "
                        f"{expected}")
    if [r[:PROMPT_LEN] for r in tokens] != prompts.tolist() or any(
            len(r) != total for r in tokens):
        failures.append("generate CLI returned malformed rows")

    flash = gen_cli.load_model("gpt2_small", str(npz), attn="flash",
                               seq_len=total)
    dense = gen_cli.load_model("gpt2_small", str(npz), attn="dense",
                               seq_len=total)
    ids = torch.as_tensor(tokens, device="cuda")
    with torch.inference_mode():
        lf, ld = flash(ids), dense(ids)
    logit_err = (lf - ld).abs().max().item()
    off_argmax = near_argmax_failures(tokens, ld, PROMPT_LEN)
    log(f"# gpt2_small: flash vs dense logits max abs err {logit_err:.3e}; "
        f"{off_argmax} emitted tokens off the dense argmax")
    if not torch.isfinite(lf).all() or logit_err > LOGIT_TOL:
        failures.append(f"gpt2_small flash logits differ from dense by "
                        f"{logit_err}")
    if off_argmax:
        failures.append(f"{off_argmax} greedy tokens are not the dense "
                        f"argmax within {ARGMAX_TOL}")

    cached = run_cli(argv + ["--use-cache"])
    with torch.inference_mode():
        lc = dense(torch.as_tensor(cached, device="cuda"))
    cache_off = near_argmax_failures(cached, lc, PROMPT_LEN)
    same = sum(a == b for ra, rb in zip(cached, tokens)
               for a, b in zip(ra[PROMPT_LEN:], rb[PROMPT_LEN:]))
    log(f"# gpt2_small --use-cache: {same}/{PROMPTS * NEW_TOKENS} tokens "
        f"identical to the flash run; {cache_off} off the dense argmax")
    if cache_off or len(cached) != PROMPTS:
        failures.append(f"--use-cache emitted {cache_off} tokens off the "
                        f"dense argmax")

    rates = {}
    for name, model, use_cache in (("flash", flash, False),
                                   ("dense", dense, False),
                                   ("cache", dense, True)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate(model, prompts, max_new_tokens=NEW_TOKENS,
                 use_cache=use_cache)
        torch.cuda.synchronize()
        rates[name] = PROMPTS * NEW_TOKENS / (time.perf_counter() - t0)
    log("# gpt2_small tokens/s (4 x 32 new, f32): " + json.dumps(rates))
    step_profile("gpt2_small full-refeed step (flash)", lambda: flash(ids))
    # One KV-cache decode step at the last position: the cache holds the
    # first total - 1 tokens, the step feeds the last one.
    cache = dense.init_cache(PROMPTS)
    with torch.inference_mode():
        dense(ids[:, :-1], cache=cache)

    def cached_step():
        cache.index = total - 1
        return dense(ids[:, -1:], cache=cache)

    step_profile("gpt2_small KV-cache step", cached_step)
    return launches


# Kernel classes of a step profile, by a substring of the kernel's name; the
# first match wins.
FLASH_KERNELS = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel",
                 "flash_fwd_tc_kernel", "flash_dq_tc_kernel",
                 "flash_dkv_tc_kernel")
FLBN_KERNELS = ("flbn_fwd_kernel", "flbn_bwd_dx_kernel", "flbn_bwd_dw_kernel",
                "flbn_fwd_tc_kernel", "flbn_bwd_dx_tc_kernel",
                "flbn_bwd_dw_tc_kernel", "flbn_column_finish_kernel",
                "flbn_dw_finish_kernel")
FCBN_KERNELS = ("fcbn_fwd_kernel", "fcbn_bwd_dx_kernel", "fcbn_bwd_dw_kernel",
                "fcbn_fwd_tc_kernel", "fcbn_bwd_dx_tc_kernel",
                "fcbn_bwd_dw_tc_kernel", "fcbn_column_finish_kernel",
                "fcbn_dw_finish_kernel")
BN_KERNELS = ("bn_stats_partial_kernel", "bn_apply_kernel",
              "bn_bwd_reduce_partial_kernel", "bn_bwd_dx_kernel",
              "bn_finish_kernel")
KERNEL_CLASSES = (
    ("flash", FLASH_KERNELS),
    # Before "bn": flbn_bwd_dx_kernel and fcbn_bwd_dx_kernel hold
    # bn_bwd_dx_kernel.
    ("conv_bn", FCBN_KERNELS),
    ("linear_bn", FLBN_KERNELS),
    ("bn", BN_KERNELS),
    # cuDNN's convolutions (before "gemm": their names hold implicit_gemm).
    ("conv", ("conv", "fprop", "dgrad", "wgrad", "cudnn", "implicit")),
    ("gemm", ("gemm", "gemv", "cutlass", "xmma", "nvjet")),
    ("optimizer", ("multi_tensor_apply",)),
    ("embedding", ("embedding", "indexing_backward", "indexselect",
                   "index_select", "radix", "segment", "scatter")),
    ("norm", ("layer_norm", "gammabeta")),
    ("softmax", ("softmax",)),
    ("pool", ("pool",)),
    ("reduce", ("reduce",)),
    ("elementwise", ("elementwise",)),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in KERNEL_CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def step_profile(label: str, step, *, grad: bool = False,
                 focus=("flash", FLASH_KERNELS)) -> dict:
    """Where one step's device time goes: torch.profiler's kernel records
    of one call of ``step``, summed by kernel name, against the wall time of
    an unprofiled call (the profiler's own host work would inflate it); the
    rest is the device's idle share. ``grad``: run with autograd (a training
    step) instead of under inference mode. ``focus``: (label, kernel names)
    whose times the record lists one by one. Returns the printed record."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    ctx = contextlib.nullcontext if grad else torch.inference_mode
    with ctx():
        step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            step()
            torch.cuda.synchronize()
    by_name: dict[str, float] = {}
    count = 0
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                e.time_range.elapsed_us()
            count += 1
    if not by_name:
        log(f"# {label} profile: device time not measured (the profiler "
            f"recorded no kernels)")
        return {}
    busy = sum(by_name.values())
    tag, names = focus
    mine = {k: sum(v for n, v in by_name.items() if k in n) for k in names}
    by_class: dict[str, float] = {}
    top: dict[str, float] = {}
    for name, us in by_name.items():
        cls = kernel_class(name)
        by_class[cls] = by_class.get(cls, 0.0) + us
        top[name[:80]] = top.get(name[:80], 0.0) + us
    record = {
        "wall_us": wall_us, "device_busy_us": busy,
        "idle_share": 1.0 - busy / wall_us, "kernels": count,
        f"{tag}_us": mine, f"{tag}_share_of_busy": sum(mine.values()) / busy,
        "by_class_us": dict(sorted(by_class.items(), key=lambda kv: -kv[1])),
        "top_kernels_us": dict(sorted(top.items(),
                                      key=lambda kv: -kv[1])[:15])}
    log(f"# {label} profile: " + json.dumps(record))
    return record


def phase_llama(fa, failures) -> None:
    """TinyLlama-1.1B widths (2048 wide, 32 heads of 64, 4 KV heads) at 2
    layers: the flash impl through the kernel against dense."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_from_flax)

    state = params_from_flax(seeded_flax_params("tinyllama_1b", SEED + 2,
                                                num_layers=2))
    models = {}
    for impl in ("flash", "dense"):
        models[impl] = get_model("tinyllama_1b", dtype=torch.float32,
                                 num_layers=2, attention_impl=impl)
        models[impl].load_state_dict(state)
    rng = np.random.default_rng(SEED + 3)
    ids = torch.as_tensor(rng.integers(0, 32000, (4, 160)), device="cuda")
    mask = torch.ones((4, 160), dtype=torch.int32, device="cuda")
    for i, n in enumerate((160, 150, 140, 130)):
        mask[i, n:] = 0
    fa.launches = 0
    with torch.inference_mode():
        lf = models["flash"](ids, attention_mask=mask)
        launches = fa.launches
        ld = models["dense"](ids, attention_mask=mask)
        ms = {impl: call_ms(lambda m=m: m(ids, attention_mask=mask))
              for impl, m in models.items()}
    err = (lf - ld).abs().max().item()
    log(f"# tinyllama_1b x2 layers: flash vs dense logits max abs err "
        f"{err:.3e}, launches {launches}, forward ms {json.dumps(ms)}")
    if launches != 2 or not torch.isfinite(lf).all() or err > LOGIT_TOL:
        failures.append(f"tinyllama flash: launches {launches}, logits "
                        f"err {err}")


def bwd_case(fa, s, b, h, d, dtype, causal, lengths, rate, seed,
             library: bool, fwd: bool = False) -> list[dict]:
    """One backward grid row: the forward kernel's o and lse feed the dq
    and dk/dv kernels and their plain versions. Returns the rows (the
    forward's too when it drops, or with ``fwd``), each with errors,
    device times, bound and, when ``library``, the library yardstick at
    rate 0: the forward and backward (dq, dk and dv together) of
    ``scaled_dot_product_attention`` with the boolean mask, both as device
    time (``library_ms``), and the backward's eager time as a caller pays
    it, host work included (``library_call_ms``)."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                   .to(tdt) for _ in range(4))
    mask_np = np.zeros((b, s), np.int32)
    for i, n in enumerate(lengths):
        mask_np[i, :n] = 1
    mask = torch.from_numpy(mask_np).to(dev)
    drop = dict(dropout_rate=rate, dropout_seed=seed - 2 ** 31)
    o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=causal, **drop)
    delta = fa._delta(do, o)
    args = (q, k, v, mask, lse, do, delta, causal, rate, seed - 2 ** 31)
    head = {"s": s, "b": b, "h": h, "d": d, "dtype": dtype, "causal": causal,
            "rate": rate, "lengths": list(lengths)}
    lib_fwd = lib_bwd = lib_bwd_call = None
    if library:
        # One library call each way at rate 0 on the same inputs: no
        # library call applies the hash mask.
        keep = mask.bool()[:, None, None, :]
        if causal:
            keep = keep & torch.ones((s, s), dtype=torch.bool,
                                     device=dev).tril()
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_()
                      for x in (q, k, v))
        with torch.no_grad():
            lib_fwd = device_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=keep))
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        dot = do.transpose(1, 2)

        def lib_grad():
            return torch.autograd.grad(out, (qt, kt, vt), dot,
                                       retain_graph=True)

        lib_bwd = kernels_ms(lib_grad)
        lib_bwd_call = call_ms(lib_grad)
        del out
    rows = []
    if rate > 0.0 or fwd:
        ref_o, ref_lse = fa.flash_attention_reference(q, k, v, mask, causal,
                                                      **drop)
        err, share = row_error(o, ref_o, *TOL[dtype])
        lse_err = (lse - ref_lse).abs().max().item()
        rows.append({"kernel": "flash_attention_fwd", **head,
                     "max_abs_err": err, "err_over_tol": share,
                     "lse_err": lse_err,
                     "ok": bool(torch.isfinite(o.float()).all())
                     and share <= 1.0 and lse_err <= TOL_LSE,
                     "ms": device_ms(lambda: fa.flash_attention_fwd(
                         q, k, v, mask, causal=causal, **drop)),
                     "plain_ms": device_ms(
                         lambda: fa.flash_attention_reference(
                             q, k, v, mask, causal, **drop)),
                     "library_ms": lib_fwd})
    dq = fa.flash_attention_dq_cuda(*args)
    dk, dv = fa.flash_attention_dkv_cuda(*args)
    torch.cuda.synchronize()
    pairs = {"flash_attention_dq": (
        [(dq, fa.flash_attention_dq_reference(*args))],
        lambda: fa.flash_attention_dq_cuda(*args),
        lambda: fa.flash_attention_dq_reference(*args)),
        "flash_attention_dkv": (
        list(zip((dk, dv), fa.flash_attention_dkv_reference(*args))),
        lambda: fa.flash_attention_dkv_cuda(*args),
        lambda: fa.flash_attention_dkv_reference(*args))}
    for name, (outs, kernel, plain) in pairs.items():
        errs = [row_error(g, ref, *TOL_GRAD[dtype]) for g, ref in outs]
        finite = all(bool(torch.isfinite(g.float()).all()) for g, _ in outs)
        # Every batch row but a fully masked one has live gradients, so an
        # all-zero reference would make the comparison empty.
        ref_max = min(ref.float().abs().max().item() for _, ref in outs)
        share = max(e[1] for e in errs)
        del outs
        rows.append({"kernel": name, **head,
                     "max_abs_err": max(e[0] for e in errs),
                     "err_over_tol": share, "ref_max_abs": ref_max,
                     "ok": finite and share <= 1.0 and ref_max > 0.0,
                     "ms": device_ms(kernel), "plain_ms": device_ms(plain),
                     "library_ms": lib_bwd, "library_call_ms": lib_bwd_call})
    for r in rows:
        r["library_rate"] = 0.0 if library else None
    kinds = {"flash_attention_fwd": "fwd", "flash_attention_dq": "dq",
             "flash_attention_dkv": "dkv"}
    for r in rows:
        r["bound_ms"], r["bound_by"] = flash_bound(mask_np, h, d, causal,
                                                   dtype, kinds[r["kernel"]])
    return rows


def phase_bwd_grid(fa, failures) -> None:
    """The backward kernels (and the forward with dropout) against their
    plain versions over S in {160, 1024, 4096} x D in {64, 128} x {f32,
    bf16} x {causal, full} x rate in {0, 0.1}. At S=160 the last batch row
    is fully masked, the middle ones ragged."""
    import torch

    rng = np.random.default_rng(SEED + 7)
    for d, h in ((64, 12), (128, 32)):
        for s, b in ((160, 4), (1024, 2), (4096, 1)):
            lengths = [s] + [int(n) for n in rng.integers(s // 2, s, b - 1)]
            if s == 160:
                lengths[-1] = 0
            for dtype in ("float32", "bfloat16"):
                for causal in (True, False):
                    for rate in (0.0, 0.1):
                        for r in bwd_case(fa, s, b, h, d, dtype, causal,
                                          lengths, rate,
                                          int(rng.integers(1e6)),
                                          library=rate == 0.0):
                            log("# bwd_grid " + json.dumps(r))
                            if not r["ok"]:
                                failures.append(
                                    f"{r['kernel']} disagrees with its "
                                    f"plain version: {r}")
                    torch.cuda.empty_cache()


def phase_train_rows(fa) -> dict:
    """Each kernel's row at the training path's shape: B=16, S=1024, 12
    heads of 64, bf16, causal, every key live, dropout 0.1. The library
    yardstick there is taken at rate 0 on the same inputs (no library call
    applies the hash mask), so every kernel is timed at rate 0 too
    (``ms_rate0``): that pair compares like with like."""
    import torch

    args = (fa, TRAIN_SEQ, TRAIN_BATCH, 12, 64, "bfloat16", True,
            [TRAIN_SEQ] * TRAIN_BATCH)
    rows = {r["kernel"]: r for r in bwd_case(*args, 0.1, SEED + 11,
                                             library=True)}
    for r in bwd_case(*args, 0.0, SEED + 11, library=False, fwd=True):
        rows[r["kernel"]]["ms_rate0"] = r["ms"]
    for r in rows.values():
        log("# train_shape " + json.dumps(r))
    torch.cuda.empty_cache()
    return rows


def phase_bwd_repeat(fa, failures) -> None:
    """The forward, dq and dk/dv at the training shape (causal, dropout
    0.1), in bf16 and f32, run twice on the same inputs: every output bit
    must repeat, since each element is summed in one fixed order without
    atomics."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    shape = (TRAIN_BATCH, TRAIN_SEQ, 12, 64)
    for dtype in ("bfloat16", "float32"):
        q, k, v, do = (torch.randn(shape, generator=gen, device=dev)
                       .to(getattr(torch, dtype)) for _ in range(4))
        mask = torch.ones(shape[:2], dtype=torch.int32, device=dev)
        fwds = [fa.flash_attention_fwd(q, k, v, mask, causal=True,
                                       dropout_rate=0.1, dropout_seed=SEED)
                for _ in range(2)]
        o, lse = fwds[0]
        args = (q, k, v, mask, lse, do, fa._delta(do, o), True, 0.1, SEED)
        runs = [(*fwd, fa.flash_attention_dq_cuda(*args),
                 *fa.flash_attention_dkv_cuda(*args)) for fwd in fwds]
        torch.cuda.synchronize()
        same = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
        log(f"# bwd_repeat {dtype}: o, lse, dq, dk, dv bit for bit {same}")
        if not all(same):
            failures.append(f"flash kernels ({dtype}) do not repeat bit for "
                            f"bit: o, lse, dq, dk, dv {same}")
        del runs, fwds
        torch.cuda.empty_cache()


def run_train_cli(argv) -> list[dict]:
    from distributeddeeplearning_tpu_torch.train import cli as train_cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = train_cli.main(argv)
    if rc != 0:
        raise RuntimeError(f"train CLI exited {rc}")
    return [json.loads(line) for line in buf.getvalue().splitlines()]


# The training path's CLI arguments.
TRAIN_ARGV = ["--model", "gpt2_small", "--batch-size", str(TRAIN_BATCH),
              "--seq-len", str(TRAIN_SEQ), "--attn", "flash", "--synthetic",
              "--steps", str(TRAIN_STEPS), "--log-every", "1",
              "--seed", str(SEED)]


def phase_train(kernels, failures) -> dict:
    """The training path: GPT-2 small at full width through the CLI, then a
    device-time profile of one step of the same configuration."""
    import torch

    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    reset_counts(kernels)
    t0 = time.perf_counter()
    lines = run_train_cli(TRAIN_ARGV)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    expected = {k["name"]: 12 * TRAIN_STEPS if k["module"] is fa else 0
                for k in kernels}
    metrics = [x for x in lines if "step" in x]
    summary = lines[-1].get("summary", {})
    losses = [x["loss"] for x in metrics]
    log(f"# gpt2_small train: CLI {cli_s:.2f} s, launches {launches}, "
        f"expected {expected}, losses {losses}, summary "
        f"{json.dumps(summary)}")
    if launches != expected:
        failures.append(f"training path launches {launches}, expected "
                        f"{expected}")
    if (len(losses) != TRAIN_STEPS
            or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - np.log(VOCAB)) > FIRST_LOSS_TOL):
        failures.append(f"training losses {losses}: need {TRAIN_STEPS} "
                        f"finite, the first within {FIRST_LOSS_TOL} of "
                        f"ln {VOCAB}")
    if not summary.get("tokens_per_sec"):
        failures.append(f"training summary without tokens/s: {summary}")
    return {"launches": launches, "summary": summary,
            "profile": gpt2_step_profile()}


def gpt2_step_profile() -> dict:
    """A device-time profile of one step of the training path's
    configuration (``step_profile``), with the tokens/s of its unprofiled
    wall time and the peak device memory."""
    import torch

    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticCausalTokens)
    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop, steps

    config = train_cli.build_config(train_cli.parse_args(TRAIN_ARGV))
    state, sched = loop.build_state(config, torch.device("cuda"))
    train_step = steps.make_train_step(config, sched)
    source = SyntheticCausalTokens(TRAIN_BATCH, TRAIN_SEQ, VOCAB, SEED,
                                   "cuda")
    batch = source.batch(0)
    torch.cuda.reset_peak_memory_stats()
    profile = step_profile("gpt2_small train step (bf16, flash, dropout "
                           "0.1)", lambda: train_step(state, batch),
                           grad=True)
    profile["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if profile.get("wall_us"):
        profile["tokens_per_sec"] = (TRAIN_BATCH * TRAIN_SEQ
                                     / profile["wall_us"] * 1e6)
    log(f"# gpt2_small train step peak memory "
        f"{profile['peak_memory_gb']:.2f} GB, "
        f"{profile.get('tokens_per_sec')} tokens/s")
    del state
    torch.cuda.empty_cache()
    return profile


# Shapes of step_ab's flash kernel times: GPT-2's training shape, and
# D=128 at S=4096; causal, (B, S, H, D).
AB_SHAPES = ((TRAIN_BATCH, TRAIN_SEQ, 12, 64), (1, 4096, 32, 128))


# step_ab's children: the flag that runs one, and the keys of its record
# that the comparison prints.
AB_RUNS = (
    ("--gpt2-step", ("wall_us", "device_busy_us", "idle_share", "flash_us",
                     "flash_share_of_busy", "tokens_per_sec",
                     "peak_memory_gb", "bwd_ms")),
    ("--resnet-step", ("wall_us", "device_busy_us", "idle_share",
                       "conv_bn_us", "linear_bn_us",
                       "fused_block_share_of_busy",
                       "images_per_sec", "peak_memory_gb", "kernel_ms")),
)


def step_ab(first: str, second: str) -> int:
    """The GPT-2 training path's step profile with the flash kernels'
    device times, then the ResNet-50 --fused-block --fused-conv3 step's
    with the 3x3 and 1x1 kernels' device times, with the port of
    checkout ``first`` and of ``second``, each in a process of its own, in
    turns: first, second, second, first. Kernels build into each
    checkout's own cache."""
    for flag, keys in AB_RUNS:
        for root in (first, second, second, first):
            proc = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), flag, root],
                capture_output=True, text=True, timeout=900)
            lines = proc.stdout.strip().splitlines()
            if proc.returncode or not lines:
                print(proc.stdout + proc.stderr, file=sys.stderr)
                return 1
            record = json.loads(lines[-1])
            log("# step_ab " + json.dumps(
                {"run": flag[2:], "checkout": root,
                 **{k: record.get(k) for k in keys}}))
    return 0


def bwd_ms() -> dict:
    """Device times of the forward, dq and dk/dv kernels at AB_SHAPES (bf16,
    causal, every key live), at rate 0.1 and 0, and of the library
    yardstick's forward (``scaled_dot_product_attention`` with the causal
    mask as a boolean mask, as the grid times it) at rate 0."""
    import torch
    import torch.nn.functional as F

    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    dev = torch.device("cuda")
    out = {}
    for b, s, h, d in AB_SHAPES:
        gen = torch.Generator(device=dev).manual_seed(SEED + 17)
        q, k, v, do = (torch.randn((b, s, h, d), generator=gen, device=dev)
                       .bfloat16() for _ in range(4))
        mask = torch.ones((b, s), dtype=torch.int32, device=dev)
        for rate in (0.1, 0.0):
            o, lse = fa.flash_attention_fwd(q, k, v, mask, causal=True,
                                            dropout_rate=rate,
                                            dropout_seed=SEED)
            args = (q, k, v, mask, lse, do, fa._delta(do, o), True, rate,
                    SEED)
            tag = f"s{s}_d{d}_rate{rate}"
            out[f"fwd_{tag}"] = device_ms(lambda: fa.flash_attention_fwd(
                q, k, v, mask, causal=True, dropout_rate=rate,
                dropout_seed=SEED))
            out[f"dq_{tag}"] = device_ms(
                lambda: fa.flash_attention_dq_cuda(*args))
            out[f"dkv_{tag}"] = device_ms(
                lambda: fa.flash_attention_dkv_cuda(*args))
        keep = torch.ones((s, s), dtype=torch.bool, device=dev).tril()
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        with torch.no_grad():
            out[f"sdpa_fwd_s{s}_d{d}_rate0.0"] = device_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       attn_mask=keep))
        del q, k, v, do, o, qt, kt, vt
        torch.cuda.empty_cache()
    return out


def gpt2_step(root: str) -> int:
    """``step_ab``'s child: one step profile and the flash kernels' times
    with the port of checkout ``root``, its record as the last line."""
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = gpt2_step_profile()
    record["bwd_ms"] = bwd_ms()
    log(json.dumps(record))
    return 0


def resnet_step(root: str) -> int:
    """``step_ab``'s other child: one step profile of ResNet-50 with
    --fused-block --fused-conv3 (bf16, batch 512) with images/s and peak
    memory, and the kernels' device times (``conv_kernel_ms``), with the
    port of checkout ``root``; its record as the last line."""
    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    if not torch.cuda.is_available():
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats()
    record = resnet_step_profile(["--fused-block", "--fused-conv3"],
                                 ("fused_block", FLBN_KERNELS + FCBN_KERNELS))
    record["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    if record.get("wall_us"):
        record["images_per_sec"] = RESNET_BATCH / record["wall_us"] * 1e6
    record["conv_bn_us"] = record.get("by_class_us", {}).get("conv_bn")
    record["linear_bn_us"] = record.get("by_class_us", {}).get("linear_bn")
    record["kernel_ms"] = conv_kernel_ms()
    log(json.dumps(record))
    return 0


def conv_kernel_ms() -> dict:
    """Device times of #11-#13 at the four stride-1 3x3 shapes of ResNet-50
    at batch 512 (prologue and ReLU on) and of #8-#10 at stage 1's conv3,
    in bf16 and f32, the 3x3 kernels' bf16 times summed over one step's 13
    layers (``step_*``), and #8's, #9's and #10's bf16 times summed over
    the 36 1x1 layers (``step_linear_{fwd,dx,dw}_bfloat16``)."""
    import torch

    from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as fcbn
    from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as flbn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    layers = resnet50_conv3_layers()
    out = {}
    for dtype in ("bfloat16", "float32"):
        tdt = getattr(torch, dtype)
        for b, h, w, c in sorted(set(layers)):
            x, dy, y = (rand(b, h, w, c).to(tdt) for _ in range(3))
            wt = rand(c, c, 3, 3, scale=(9 * c) ** -0.5).to(
                tdt, memory_format=torch.channels_last)
            vecs = (rand(c, scale=0.3), rand(c).abs() + 0.5,
                    rand(c).abs() + 0.5, rand(c, scale=0.3))
            ds, dss = rand(c, scale=0.1), rand(c, scale=0.1)
            tag = f"{dtype}_{h}x{w}_c{c}"
            out[f"fwd_{tag}"] = device_ms(lambda: fcbn.conv3x3_bn_fwd(
                x, *vecs, wt, relu=True, bn=True))
            out[f"dx_{tag}"] = device_ms(lambda: fcbn.conv3x3_bn_bwd_dx(
                dy, y, ds, dss, wt, x, *vecs, relu=True, bn=True))
            out[f"dw_{tag}"] = device_ms(lambda: fcbn.conv3x3_bn_bwd_dw(
                x, *vecs, dy, y, ds, dss, relu=True, bn=True))
            del x, dy, y
            torch.cuda.empty_cache()
        m, k, n, bn, relu = resnet50_linear_layers()[1]
        x, wl = rand(m, k).to(tdt), rand(n, k, scale=k ** -0.5).to(tdt)
        vecs = (rand(k, scale=0.3), rand(k).abs() + 0.5, rand(k).abs() + 0.5,
                rand(k, scale=0.3))
        dy, y = rand(m, n).to(tdt), rand(m, n).to(tdt)
        ds, dss = rand(n, scale=0.1), rand(n, scale=0.1)
        tag = f"{dtype}_m{m}_k{k}_n{n}"
        out[f"linear_fwd_{tag}"] = device_ms(lambda: flbn.linear_bn_fwd(
            x, *vecs, wl, relu=relu, bn=bn))
        out[f"linear_dx_{tag}"] = device_ms(lambda: flbn.linear_bn_bwd_dx(
            dy, y, ds, dss, wl, x, *vecs, relu=relu, bn=bn))
        out[f"linear_dw_{tag}"] = device_ms(lambda: flbn.linear_bn_bwd_dw(
            x, *vecs, dy, y, ds, dss, relu=relu, bn=bn))
        del x, dy, y
        torch.cuda.empty_cache()
    for kind in ("fwd", "dx", "dw"):
        out[f"step_{kind}_bfloat16"] = sum(
            out[f"{kind}_bfloat16_{h}x{w}_c{c}"] for _, h, w, c in layers)
    linear = resnet50_linear_layers()
    lin_ms = {"fwd": {}, "dx": {}, "dw": {}}
    for m, k, n, bn, relu in sorted(set(linear)):
        x, dy, y = (rand(m, c).bfloat16() for c in (k, n, n))
        wl = rand(n, k, scale=k ** -0.5).bfloat16()
        vecs = (rand(k, scale=0.3), rand(k).abs() + 0.5, rand(k).abs() + 0.5,
                rand(k, scale=0.3)) if bn else (None,) * 4
        ds, dss = rand(n, scale=0.1), rand(n, scale=0.1)
        v = (m, k, n, bn, relu)
        lin_ms["fwd"][v] = device_ms(lambda: flbn.linear_bn_fwd(
            x, *vecs, wl, relu=relu, bn=bn))
        lin_ms["dx"][v] = device_ms(lambda: flbn.linear_bn_bwd_dx(
            dy, y, ds, dss, wl, x, *vecs, relu=relu, bn=bn))
        lin_ms["dw"][v] = device_ms(lambda: flbn.linear_bn_bwd_dw(
            x, *vecs, dy, y, ds, dss, relu=relu, bn=bn))
        del x, dy, y
        torch.cuda.empty_cache()
    for kind, ms in lin_ms.items():
        out[f"step_linear_{kind}_bfloat16"] = sum(ms[v] for v in linear)
    return out


def phase_flash_vs_dense_step(failures) -> None:
    """One f32 training step of GPT-2 small at batch 4 x 1024 through
    flash and through dense: same weights, batch and dropout seeds (the
    hash mask drops the same attention probabilities; the residual sites
    draw the same device generators). Loss and every gradient compared."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.losses import (
        causal_lm_loss)
    from distributeddeeplearning_tpu_torch.train.steps import dropout_rng

    ids = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        1, VOCAB, (DENSE_BATCH, TRAIN_SEQ)), device="cuda")
    grads, losses = {}, {}
    state = None
    torch.manual_seed(SEED + 6)  # the weights, from a seed
    for impl in ("flash", "dense"):
        model = get_model("gpt2_small", dtype=torch.float32,
                          attention_impl=impl).train()
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        logits = model(ids, rng=dropout_rng(SEED, 0))
        loss = causal_lm_loss(logits, ids)
        del logits
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model
    top = max(g.abs().max().item() for g in grads["dense"].values())
    worst = 0.0
    for name, ref in grads["dense"].items():
        scale = max(ref.abs().max().item(), 1e-4 * top)
        worst = max(worst, (grads["flash"][name] - ref).abs().max().item()
                    / scale)
    loss_err = abs(losses["flash"] - losses["dense"])
    log(f"# gpt2_small f32 train step, flash vs dense (batch "
        f"{DENSE_BATCH} x {TRAIN_SEQ}, dropout 0.1): losses "
        f"{json.dumps(losses)}, loss err {loss_err:.3e}, worst gradient err "
        f"{worst:.3e} of its scale")
    if not np.isfinite(loss_err) or loss_err > STEP_LOSS_TOL \
            or not worst <= STEP_GRAD_TOL:
        failures.append(f"flash vs dense training step: loss err "
                        f"{loss_err}, gradient err {worst}")
    del grads
    torch.cuda.empty_cache()


def resnet50_bn_layers() -> list[tuple]:
    """(N, H, W, C, relu, residual) of each of ResNet-50's BatchNorm layers
    at the training path's batch and image size, in forward order: a
    forward of the unfused model on the meta device, recorded by hooks."""
    import torch

    from distributeddeeplearning_tpu_torch.models import resnet

    layers = []

    def record(mod, args, out):
        n, c, h, w = args[0].shape
        layers.append((n, h, w, c, mod.relu, len(args) > 1))

    with torch.device("meta"):
        model = resnet.resnet50(dtype=torch.bfloat16).train()
        for mod in model.modules():
            if isinstance(mod, resnet.BatchNormAct):
                mod.register_forward_hook(record)
        model(torch.empty(RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3))
    return layers


def bn_bytes(m: int, c: int, dtype: str, relu: bool, res: bool) -> dict:
    """The bytes each BatchNorm kernel must move at (M, C): each (M, C)
    input read once, each (M, C) output written once, the f32 (C,) vectors
    read or written once."""
    e, vec = m * c * (4 if dtype == "float32" else 2), 4 * c
    return {"bn_stats": e + 2 * vec,                             # x; mean, var
            "bn_apply": (2 + res) * e + 4 * vec,         # x [res], y; 4 vecs
            "bn_bwd_reduce": (2 + relu) * e + 4 * vec,   # dy, x [y]; 4 vecs
            "bn_bwd_dx": (3 + relu + res) * e + 6 * vec}  # dy, x [y], dx [dres]


def col_share(out, ref, limit) -> tuple[float, float]:
    """(max abs error, largest error as a share of its column's limit)."""
    diff = (out.float() - ref.float()).abs()
    return diff.max().item(), (diff / limit).max().item()


def bn_case(bn, n, h, w, c, relu, res, dtype, seed) -> list[dict]:
    """One grid row: kernels #4-#7 at (M, C) = (N*H*W, C) against their
    plain versions, with device times, bounds and the library yardstick
    (``F.batch_norm`` in training on the channels_last tensor: its forward
    for #4 and #5, its backward for #6 and #7). #4 and #6 run twice and
    must agree bit for bit."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    m = n * h * w
    gen = torch.Generator(device=dev).manual_seed(seed)
    x, dy, r = (torch.randn((m, c), generator=gen, device=dev).to(tdt)
                for _ in range(3))
    r = r if res else None
    gamma, beta = (torch.rand(c, generator=gen, device=dev) + 0.5
                   for _ in range(2))
    xf = x.float()
    rtol = BN_ROW_TOL[dtype]
    mean, var = bn.bn_stats(x)
    again = bn.bn_stats(x)
    ref_mean, ref_var = bn.bn_stats_reference(x)
    inv = torch.rsqrt(var + BN_EPS)
    errs = {"bn_stats": [
        col_share(mean, ref_mean, BN_SUM_TOL * xf.abs().mean(dim=0)),
        col_share(var, ref_var, BN_SUM_TOL * 2 * (xf * xf).mean(dim=0))]}
    repeat = {"bn_stats": all(torch.equal(a, b)
                              for a, b in zip((mean, var), again))}
    y = bn.bn_apply(x, mean, inv, gamma, beta, r, relu=relu)
    ref_y = bn.bn_apply_reference(x, mean, inv, gamma, beta, r, relu=relu)
    errs["bn_apply"] = [col_share(y, ref_y, rtol * ref_y.float().abs().amax(
        dim=0) + 1e-30)]
    db, dg = bn.bn_bwd_reduce(dy, y, x, mean, inv, relu=relu)
    again = bn.bn_bwd_reduce(dy, y, x, mean, inv, relu=relu)
    ref_db, ref_dg = bn.bn_bwd_reduce_reference(dy, y, x, mean, inv,
                                                relu=relu)
    dz = torch.where(y.float() > 0, dy.float(), 0.0) if relu else dy.float()
    errs["bn_bwd_reduce"] = [
        col_share(db, ref_db, BN_SUM_TOL * dz.abs().sum(dim=0)),
        col_share(dg, ref_dg, BN_SUM_TOL * (dz * (xf - mean) * inv).abs()
                  .sum(dim=0))]
    repeat["bn_bwd_reduce"] = all(torch.equal(a, b)
                                  for a, b in zip((db, dg), again))
    del dz, xf
    outs = bn.bn_bwd_dx(dy, y, x, mean, inv, gamma, db, dg, relu=relu,
                        want_dres=res)
    refs = bn.bn_bwd_dx_reference(dy, y, x, mean, inv, gamma, db, dg,
                                  relu=relu, want_dres=res)
    errs["bn_bwd_dx"] = [col_share(o, rf, rtol * rf.float().abs().amax(
        dim=0) + 1e-30) for o, rf in zip(outs, refs) if rf is not None]
    finite = all(bool(torch.isfinite(t.float()).all())
                 for t in (mean, var, y, db, dg, *(o for o in outs
                                                   if o is not None)))
    del outs, refs, ref_y
    torch.cuda.synchronize()

    runs = {
        "bn_stats": (lambda: bn.bn_stats(x),
                     lambda: bn.bn_stats_reference(x)),
        "bn_apply": (lambda: bn.bn_apply(x, mean, inv, gamma, beta, r,
                                         relu=relu),
                     lambda: bn.bn_apply_reference(x, mean, inv, gamma, beta,
                                                   r, relu=relu)),
        "bn_bwd_reduce": (lambda: bn.bn_bwd_reduce(dy, y, x, mean, inv,
                                                   relu=relu),
                          lambda: bn.bn_bwd_reduce_reference(
                              dy, y, x, mean, inv, relu=relu)),
        "bn_bwd_dx": (lambda: bn.bn_bwd_dx(dy, y, x, mean, inv, gamma, db, dg,
                                           relu=relu, want_dres=res),
                      lambda: bn.bn_bwd_dx_reference(
                          dy, y, x, mean, inv, gamma, db, dg, relu=relu,
                          want_dres=res)),
    }
    # The library: one F.batch_norm in training on the same x as the
    # channels_last (N, C, H, W) tensor, forward and (eager) backward.
    x4 = x.view(n, h, w, c).permute(0, 3, 1, 2).detach().requires_grad_()
    w4, b4 = (t.clone().requires_grad_() for t in (gamma, beta))
    run_mean, run_var = torch.zeros(c, device=dev), torch.ones(c, device=dev)
    with torch.no_grad():
        lib_fwd = device_ms(lambda: F.batch_norm(
            x4, run_mean, run_var, w4, b4, training=True, eps=BN_EPS))
    out4 = F.batch_norm(x4, run_mean, run_var, w4, b4, training=True,
                        eps=BN_EPS)
    dy4 = dy.view(n, h, w, c).permute(0, 3, 1, 2)
    lib_bwd = call_ms(lambda: torch.autograd.grad(out4, (x4, w4, b4), dy4,
                                                  retain_graph=True))
    del out4
    nbytes = bn_bytes(m, c, dtype, relu, res)
    rows = []
    for name, (kernel, plain) in runs.items():
        share = max(e[1] for e in errs[name])
        rows.append({
            "kernel": name, "n": n, "h": h, "w": w, "m": m, "c": c,
            "dtype": dtype, "relu": relu, "residual": res,
            "max_abs_err": max(e[0] for e in errs[name]),
            "err_over_tol": share, "repeats": repeat.get(name),
            "ok": finite and share <= 1.0 and repeat.get(name, True),
            "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": lib_fwd if name in ("bn_stats", "bn_apply")
            else lib_bwd,
            "bound_ms": nbytes[name] / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes"})
    return rows


def phase_bn_grid(bn, failures) -> dict:
    """Kernels #4-#7 over the distinct (M, C, relu, residual) variants of
    ResNet-50's BatchNorm layers at batch 512, in bf16 (the training path's
    dtype) and f32. Returns {dtype: {variant: rows by kernel}} and logs
    each row, and for bf16 each kernel's time summed over one step's 53
    layers."""
    import torch

    layers = resnet50_bn_layers()
    variants = sorted(set(layers), key=lambda v: -v[0] * v[1] * v[2] * v[3])
    grid = {}
    seed = SEED + 20
    for dtype in ("bfloat16", "float32"):
        grid[dtype] = {}
        for v in variants:
            seed += 1
            rows = bn_case(bn, *v, dtype, seed)
            grid[dtype][v] = {r["kernel"]: r for r in rows}
            for r in rows:
                log("# bn_grid " + json.dumps(r))
                if not r["ok"]:
                    failures.append(f"{r['kernel']} disagrees with its plain "
                                    f"version or does not repeat: {r}")
            torch.cuda.empty_cache()
    step = {}
    for name in ("bn_stats", "bn_apply", "bn_bwd_reduce", "bn_bwd_dx"):
        step[name] = {key: sum(grid["bfloat16"][v][name][key] for v in layers)
                      for key in ("ms", "bound_ms", "plain_ms",
                                  "library_ms")}
    log("# bn_grid one ResNet-50 step (53 layers, bf16, batch 512), summed "
        "ms by kernel: " + json.dumps(step))
    return {"grid": grid, "step": step, "stem": layers[0]}


def resnet_step_profile(flags, focus) -> dict:
    """A device-time profile of one ResNet-50 training step at batch 512
    (bf16) with the CLI's ``flags``, from the seeded state."""
    import torch

    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop, steps

    argv = ["--model", "resnet50", "--batch-size", str(RESNET_BATCH),
            "--synthetic", "--steps", str(RESNET_STEPS), "--seed",
            str(SEED), *flags]
    config = train_cli.build_config(train_cli.parse_args(argv))
    state, sched = loop.build_state(config, torch.device("cuda"))
    train_step = steps.make_train_step(config, sched)
    batch = loop.make_source(config, state.model, "cuda").batch(0)
    profile = step_profile(f"resnet50 train step (bf16, "
                           f"{' '.join(flags) or 'unfused'}, batch "
                           f"{RESNET_BATCH})", lambda: train_step(state,
                                                                  batch),
                           grad=True, focus=focus)
    del state, batch
    torch.cuda.empty_cache()
    return profile


def phase_resnet_train(kernels, failures, flags, per_step, focus) -> dict:
    """A ResNet training path: ResNet-50 with ``flags`` (--fused-bn,
    --fused-block, or --fused-block --fused-conv3) at batch 512 through the
    CLI, where each kernel of a module of ``per_step`` ({module: launches a
    step}) must launch that many times a step and no other kernel of the
    port at all; then a device-time profile of one step of the same
    configuration."""
    import torch

    flag = " ".join(flags)
    argv = ["--model", "resnet50", "--batch-size", str(RESNET_BATCH),
            "--synthetic", *flags, "--steps", str(RESNET_STEPS),
            "--log-every", "1", "--seed", str(SEED)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    lines = run_train_cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    expected = {k["name"]: per_step.get(k["module"], 0) * RESNET_STEPS
                for k in kernels}
    metrics = [x for x in lines if "step" in x]
    summary = lines[-1].get("summary", {})
    losses = [x["loss"] for x in metrics]
    log(f"# resnet50 {flag} train: CLI {cli_s:.2f} s, launches "
        f"{launches}, expected {expected}, losses {losses}, peak memory "
        f"{peak_gb:.2f} GB, summary {json.dumps(summary)}")
    if launches != expected:
        failures.append(f"ResNet training path launches {launches}, "
                        f"expected {expected}")
    if (len(losses) != RESNET_STEPS
            or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - np.log(RESNET_CLASSES))
            > RESNET_FIRST_LOSS_TOL):
        failures.append(f"ResNet losses {losses}: need {RESNET_STEPS} "
                        f"finite, the first within {RESNET_FIRST_LOSS_TOL} "
                        f"of ln {RESNET_CLASSES}")
    if not summary.get("examples_per_sec"):
        failures.append(f"ResNet summary without images/s: {summary}")
    profile = resnet_step_profile(flags, focus)
    return {"launches": launches, "summary": summary, "profile": profile,
            "peak_memory_gb": peak_gb, "losses": losses}


def phase_fused_vs_unfused_step(failures, fused: dict) -> None:
    """One step of ResNet-50 at batch 32 in f32 with each model option set
    of ``fused`` ({label: get_model keywords}: fused_bn; fused_block;
    fused_block with fused_conv3), and unfused in f32 and in f64 as the
    reference of exact arithmetic: the same seeded weights and batch. Each
    fused step's loss and updated running buffers are compared with the
    unfused f32 step's, its gradients with the f64 step's: fused_bn's
    relative to the unfused f32 step's distance, the others directly."""
    import torch

    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticImages)
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.losses import (
        smoothed_softmax_ce)

    batch = SyntheticImages(FUSED_BATCH, RESNET_IMAGE, RESNET_CLASSES,
                            SEED + 9, "cuda").batch(0)
    results, state = {}, None
    torch.manual_seed(SEED + 10)  # the weights, from a seed
    runs = [*((label, torch.float32, kw) for label, kw in fused.items()),
            ("unfused", torch.float32, {}), ("f64", torch.float64, {})]
    for name, dtype, kw in runs:
        model = get_model("resnet50", dtype=dtype, **kw).train()
        if state is None:  # a copy: the forward updates the buffers
            state = {k: v.clone() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        loss = smoothed_softmax_ce(model(batch["image"]), batch["label"])
        loss.backward()
        results[name] = (loss.item(), {n: p.grad.double() for n, p in
                                       model.named_parameters()},
                         {n: b.clone() for n, b in model.named_buffers()})
        del model, loss
        torch.cuda.empty_cache()
    loss_u, grads_u, bufs_u = results["unfused"]
    grads_x = results["f64"][1]
    top = max(g.abs().max().item() for g in grads_x.values())
    norm = sum((g * g).sum().item() for g in grads_x.values()) ** 0.5

    def errs(grads, ref):
        """(worst tensor, its name, 2-norm error over all tensors)."""
        worst = max((((grads[n] - g).abs().max().item()
                      / max(g.abs().max().item(), 1e-4 * top)), n)
                    for n, g in ref.items())
        total = sum(((grads[n] - g) ** 2).sum().item()
                    for n, g in ref.items()) ** 0.5
        return worst[0], worst[1], total / norm

    unfused = errs(grads_u, grads_x)
    for label in fused:
        loss_f, grads_f, bufs_f = results[label]
        mine, between = errs(grads_f, grads_x), errs(grads_f, grads_u)
        buf_err = max((bufs_f[n] - b).abs().max().item()
                      / max(b.abs().max().item(), 1.0)
                      for n, b in bufs_u.items())
        loss_err = abs(loss_f - loss_u)
        log(f"# resnet50 step, {label} f32 vs unfused f32 vs unfused f64 "
            f"(batch {FUSED_BATCH}): losses {loss_f!r} / {loss_u!r}, loss "
            f"err {loss_err:.3e}, worst running-buffer err {buf_err:.3e}; "
            f"gradients against f64, worst tensor and 2-norm: fused "
            f"{mine[0]:.3e} ({mine[1]}), {mine[2]:.3e}; unfused "
            f"{unfused[0]:.3e} ({unfused[1]}), {unfused[2]:.3e}; fused "
            f"against unfused {between[0]:.3e} ({between[1]}), "
            f"{between[2]:.3e}")
        if label == "fused_bn":
            grads_ok = (mine[0] <= FUSED_GRAD_FACTOR * unfused[0]
                        and mine[2] <= FUSED_GRAD_FACTOR * unfused[2])
        else:
            grads_ok = (mine[0] <= FUSED_BLOCK_GRAD_WORST
                        and mine[2] <= FUSED_BLOCK_GRAD_NORM)
        if not (loss_err <= FUSED_LOSS_TOL and buf_err <= FUSED_BUFFER_TOL
                and grads_ok):
            failures.append(f"{label} vs unfused ResNet step: loss err "
                            f"{loss_err}, buffer err {buf_err}, gradient "
                            f"errs against f64 fused {mine}, unfused "
                            f"{unfused}")
    del results, grads_u, grads_x
    torch.cuda.empty_cache()


def resnet50_linear_layers() -> list[tuple]:
    """(M, K, N, bn, relu) of each 1x1 convolution that --fused-block runs
    through kernels #8-#10, at the training path's batch and image size, in
    forward order: each bottleneck's conv1 (bn off), conv3 (bn and ReLU on)
    and downsample (bn off), from the shapes of the model's blocks."""
    import torch

    from distributeddeeplearning_tpu_torch.models import resnet

    with torch.device("meta"):
        model = resnet.resnet50(dtype=torch.bfloat16)
    side = RESNET_IMAGE // 4   # after the stem's stride and the max-pool's
    layers = []
    for name, block in model.named_children():
        if not name.startswith("stage"):
            continue
        f, cin = block.conv1.weight.shape[:2]
        out = -(-side // block.conv2.stride)
        m_in, m_out = RESNET_BATCH * side * side, RESNET_BATCH * out * out
        layers.append((m_in, cin, f, False, False))
        layers.append((m_out, f, 4 * f, True, True))
        if hasattr(block, "downsample_conv"):
            layers.append((m_out, cin, 4 * f, False, False))
        side = out
    return layers


def linear_bn_bound(kernel: str, m: int, k: int, n: int, bn: bool,
                    dtype: str) -> tuple[float, str]:
    """The least time of kernel #8, #9 or #10 at (M, K, N): 2 M K N FLOPs at
    the dtype's peak, against its bytes over HBM, each input read once and
    each output written once: (M, K), (N, K) and (M, N) operands in the
    dtype, the f32 vectors (mu, inv, gamma, beta with ``bn``; sum and sumsq
    or ds and dss; dbeta and dgamma with ``bn``). Returns (ms, bound_by)."""
    e = 4 if dtype == "float32" else 2
    vk = 4 * k * 4 if bn else 0
    nbytes = {
        "linear_bn_fwd": (m * k + n * k + m * n) * e + vk + 2 * n * 4,
        "linear_bn_bwd_dx": ((2 * m * n + n * k + m * k + (m * k if bn else 0))
                             * e + 2 * n * 4 + vk + (2 * k * 4 if bn else 0)),
        "linear_bn_bwd_dw": (m * k + 2 * m * n + n * k) * e + vk + 2 * n * 4,
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * k * n / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def prod_share(out, ref) -> tuple[float, float]:
    """(max abs error, largest error as a share of its element's limit:
    FLBN_PROD_TOL of its column's largest |ref|, plus one ulp of the
    element for a bf16 output)."""
    import torch

    r = ref.float()
    limit = FLBN_PROD_TOL * r.abs().amax(dim=0)
    if ref.dtype == torch.bfloat16:
        _, e = torch.frexp(r)
        limit = limit + torch.where(
            r != 0, torch.ldexp(torch.ones_like(r), e - 8), 0.0)
    diff = (out.float() - r).abs()
    return diff.max().item(), (diff / (limit + 1e-30)).max().item()


def linear_bn_case(flbn, m, k, n, bn, relu, dtype, seed) -> list[dict]:
    """One grid row: kernels #8-#10 at (M, K, N) against their plain
    versions, with device times, bounds and the library yardstick (one
    ``torch.matmul`` of the bare product, no prologue and no sums). The
    reductions run twice and must agree bit for bit."""
    import torch

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    x = rand(m, k).to(tdt)
    w = rand(n, k, scale=k ** -0.5).to(tdt)
    vecs = ((rand(k, scale=0.3), rand(k).abs() + 0.5, rand(k).abs() + 0.5,
             rand(k, scale=0.3)) if bn else (None,) * 4)
    mu, inv, gamma, beta = vecs
    dy, y = rand(m, n).to(tdt), rand(m, n).to(tdt)
    ds, dss = rand(n, scale=0.1), rand(n, scale=0.1)
    mode = dict(relu=relu, bn=bn)
    errs, repeat = {}, {}

    out, s, ss = flbn.linear_bn_fwd(x, *vecs, w, **mode)
    _, s2, ss2 = flbn.linear_bn_fwd(x, *vecs, w, **mode)
    repeat["linear_bn_fwd"] = torch.equal(s, s2) and torch.equal(ss, ss2)
    ref, rs, rss = flbn.linear_bn_fwd_reference(x, *vecs, w, **mode)
    of, rf = out.float(), ref.float()
    sum_limits = (FLBN_SUM_TOL * rf.abs().sum(dim=0)
                  + (of - rf).abs().sum(dim=0) + 1e-30,
                  FLBN_SUM_TOL * (rf * rf).sum(dim=0)
                  + (of * of - rf * rf).abs().sum(dim=0) + 1e-30)
    errs["linear_bn_fwd"] = [prod_share(out, ref),
                             col_share(s, rs, sum_limits[0]),
                             col_share(ss, rss, sum_limits[1])]

    def middle_run(dx):
        """The rows of the middle block's run of #8 (dx False) or #9."""
        run = flbn.run_rows(m, k, n, tdt, dx=dx, bn=bn)
        r0 = (-(-m // run) // 2) * run
        return slice(r0, r0 + run)

    # The limits must see sums that lack one block's run of pixels: the
    # middle block's, taken out of the kernel's own sums.
    gone = of[middle_run(False)].double()
    lost_run = {"linear_bn_fwd": min(
        col_share((s.double() - gone.sum(dim=0)).float(), rs,
                  sum_limits[0])[1],
        col_share((ss.double() - (gone * gone).sum(dim=0)).float(), rss,
                  sum_limits[1])[1])}
    finite = bool(torch.isfinite(of).all())
    del out, ref, of, rf, s2, ss2, gone, sum_limits

    dx, db, dg = flbn.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs, **mode)
    again = flbn.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs, **mode)
    repeat["linear_bn_bwd_dx"] = (torch.equal(db, again[1])
                                  and torch.equal(dg, again[2])) if bn \
        else None
    rdx, rdb, rdg = flbn.linear_bn_bwd_dx_reference(dy, y, ds, dss, w, x,
                                                    *vecs, **mode)
    dyt = flbn._dy_total(dy, y, ds, dss).float()
    errs["linear_bn_bwd_dx"] = [prod_share(dx, rdx)]
    if bn:
        xh = (x.float() - mu) * inv
        da = dyt @ w.float()
        dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
        limits = (FLBN_SUM_TOL * dz.abs().sum(dim=0) + 1e-30,
                  FLBN_SUM_TOL * (dz * xh).abs().sum(dim=0) + 1e-30)
        errs["linear_bn_bwd_dx"] += [col_share(db, rdb, limits[0]),
                                     col_share(dg, rdg, limits[1])]
        rows = middle_run(True)
        lost_run["linear_bn_bwd_dx"] = min(
            col_share((db.double() - dz[rows].double().sum(dim=0)).float(),
                      rdb, limits[0])[1],
            col_share((dg.double() - (dz[rows].double() * xh[rows])
                       .sum(dim=0)).float(), rdg, limits[1])[1])
        del xh, da, dz, limits
    finite = finite and bool(torch.isfinite(dx.float()).all())
    del dx, again, rdx

    dw = flbn.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode)
    repeat["linear_bn_bwd_dw"] = torch.equal(
        dw, flbn.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode))
    rdw = flbn.linear_bn_bwd_dw_reference(x, *vecs, dy, y, ds, dss, **mode)
    errs["linear_bn_bwd_dw"] = [prod_share(dw, rdw)]
    # The limit must see a dw that lacks one of the kernel's chunks of M:
    # this one lacks the middle chunk's rows.
    chunk = -(-m // flbn.dw_splits(m, k, n, tdt))
    r0 = min(m // 2, m - chunk)
    a = flbn._prologue(x[r0:r0 + chunk], *vecs, relu, bn).float()
    lost = dyt[r0:r0 + chunk].t() @ a
    dropped = prod_share((dw.float() - lost).to(tdt), rdw)[1]
    finite = finite and bool(torch.isfinite(dw.float()).all())
    del dw, rdw, dyt, a, lost
    torch.cuda.synchronize()

    runs = {
        "linear_bn_fwd": (
            lambda: flbn.linear_bn_fwd(x, *vecs, w, **mode),
            lambda: flbn.linear_bn_fwd_reference(x, *vecs, w, **mode),
            lambda: torch.matmul(x, w.t())),
        "linear_bn_bwd_dx": (
            lambda: flbn.linear_bn_bwd_dx(dy, y, ds, dss, w, x, *vecs,
                                          **mode),
            lambda: flbn.linear_bn_bwd_dx_reference(dy, y, ds, dss, w, x,
                                                    *vecs, **mode),
            lambda: torch.matmul(dy, w)),
        "linear_bn_bwd_dw": (
            lambda: flbn.linear_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode),
            lambda: flbn.linear_bn_bwd_dw_reference(x, *vecs, dy, y, ds, dss,
                                                    **mode),
            lambda: torch.matmul(dy.t(), x)),
    }
    rows = []
    for name, (kernel, plain, library) in runs.items():
        share = max(e[1] for e in errs[name])
        ok_repeat = repeat[name] is not False
        sees_drop = (name != "linear_bn_bwd_dw" or dropped > 1.0) and \
            lost_run.get(name, 2.0) > 1.0
        bound, by = linear_bn_bound(name, m, k, n, bn, dtype)
        rows.append({
            "kernel": name, "m": m, "k": k, "n": n, "bn": bn, "relu": relu,
            "dtype": dtype, "max_abs_err": max(e[0] for e in errs[name]),
            "err_over_tol": share, "repeats": repeat[name],
            **({"dropped_chunk_over_tol": dropped}
               if name == "linear_bn_bwd_dw" else {}),
            **({"lost_run_over_tol": lost_run[name]}
               if name in lost_run else {}),
            "ok": finite and share <= 1.0 and ok_repeat and sees_drop,
            "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library), "bound_ms": bound,
            "bound_by": by})
    return rows


def phase_linear_bn_grid(flbn, failures) -> dict:
    """Kernels #8-#10 over the distinct (M, K, N, bn, relu) variants of
    ResNet-50's 36 bottleneck 1x1 convolutions at batch 512, plus conv3's
    shape of stage 2 with the prologue but no ReLU, in bf16 (the training
    path's dtype) and f32. Returns {dtype: {variant: rows by kernel}},
    logs each row, and for bf16 each kernel's time summed over one step's
    36 layers."""
    import torch

    layers = resnet50_linear_layers()
    variants = sorted(set(layers), key=lambda v: -v[0] * v[1] * v[2])
    conv3 = next(v for v in layers if v[1:] == (128, 512, True, True))
    variants.append((conv3[0], 128, 512, True, False))
    grid = {}
    seed = SEED + 40
    for dtype in ("bfloat16", "float32"):
        grid[dtype] = {}
        for v in variants:
            seed += 1
            rows = linear_bn_case(flbn, *v, dtype, seed)
            grid[dtype][v] = {r["kernel"]: r for r in rows}
            for r in rows:
                log("# linear_bn_grid " + json.dumps(r))
                if not r["ok"]:
                    failures.append(f"{r['kernel']} disagrees with its plain "
                                    f"version or does not repeat, or its "
                                    f"limit passes a lost chunk or run: "
                                    f"{r}")
            torch.cuda.empty_cache()
    step = {}
    for name in ("linear_bn_fwd", "linear_bn_bwd_dx", "linear_bn_bwd_dw"):
        step[name] = {key: sum(grid["bfloat16"][v][name][key] for v in layers)
                      for key in ("ms", "bound_ms", "plain_ms",
                                  "library_ms")}
    log("# linear_bn_grid one ResNet-50 step (36 layers, bf16, batch 512), "
        "summed ms by kernel: " + json.dumps(step))
    # The main row: stage 1's conv3, the prologue and ReLU on.
    return {"grid": grid, "step": step, "main": layers[1]}


def resnet50_conv3_layers() -> list[tuple]:
    """(B, H, W, C) of each 3x3 convolution that --fused-conv3 runs through
    kernels #11-#13, at the training path's batch and image size, in
    forward order: the conv2 of each stride-1 bottleneck, C in and out."""
    import torch

    from distributeddeeplearning_tpu_torch.models import resnet

    with torch.device("meta"):
        model = resnet.resnet50(dtype=torch.bfloat16)
    side = RESNET_IMAGE // 4   # after the stem's stride and the max-pool's
    layers = []
    for name, block in model.named_children():
        if not name.startswith("stage"):
            continue
        if block.conv2.stride == 1:
            layers.append((RESNET_BATCH, side, side,
                           block.conv2.weight.shape[0]))
        side = -(-side // block.conv2.stride)
    return layers


def conv_bn_bound(kernel: str, b: int, h: int, w: int, cin: int, cout: int,
                  bn: bool, dtype: str) -> tuple[float, str]:
    """The least time of kernel #11, #12 or #13 on (B, H, W): 2 M 9 Cin
    Cout FLOPs (M = B H W) at the dtype's peak, against its bytes over HBM,
    each input read once and each output written once: the (M, Cin) and
    (M, Cout) activations and the (Cout, 9 Cin) weight in the dtype, the
    f32 vectors (mu, inv, gamma, beta with ``bn``; sum and sumsq or ds and
    dss; dbeta and dgamma with ``bn``). Returns (ms, bound_by)."""
    e = 4 if dtype == "float32" else 2
    m = b * h * w
    wb = 9 * cin * cout * e
    vk = 4 * cin * 4 if bn else 0
    nbytes = {
        "conv3x3_bn_fwd": (m * cin + m * cout) * e + wb + vk + 2 * cout * 4,
        "conv3x3_bn_bwd_dx": ((2 * m * cout + m * cin + (m * cin if bn else 0))
                              * e + wb + 2 * cout * 4 + vk
                              + (2 * cin * 4 if bn else 0)),
        "conv3x3_bn_bwd_dw": (m * cin + 2 * m * cout) * e + wb + vk
        + 2 * cout * 4,
    }[kernel]
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = 2 * m * 9 * cin * cout / PEAK_FLOPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def conv_bn_case(fcbn, b, h, w, cin, cout, bn, relu, dtype,
                 seed) -> list[dict]:
    """One grid row: kernels #11-#13 on (B, H, W, Cin -> Cout) against their
    plain versions, with device times, bounds and the library yardstick
    (one cuDNN call of the bare convolution: ``F.conv2d``, and
    ``torch.nn.grad.conv2d_input`` and ``conv2d_weight`` for the backward,
    with no prologue and no sums). The reductions run twice and must agree
    bit for bit; the dw check must fail a dw that lacks one of #13's chunks
    of M, and the checks of #11's and #12's sums sums that lack one block's
    run of pixels."""
    import torch
    import torch.nn.functional as F

    dev = torch.device("cuda")
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def rows(t):
        return t.reshape(-1, t.shape[-1])

    def dw_rows(t):
        return t.permute(0, 2, 3, 1).reshape(t.shape[0], -1)

    m = b * h * w
    x = rand(b, h, w, cin).to(tdt)
    wt = rand(cout, cin, 3, 3, scale=(9 * cin) ** -0.5).to(
        tdt, memory_format=torch.channels_last)
    vecs = ((rand(cin, scale=0.3), rand(cin).abs() + 0.5,
             rand(cin).abs() + 0.5, rand(cin, scale=0.3)) if bn
            else (None,) * 4)
    mu, inv, gamma, beta = vecs
    dy, y = rand(b, h, w, cout).to(tdt), rand(b, h, w, cout).to(tdt)
    ds, dss = rand(cout, scale=0.1), rand(cout, scale=0.1)
    mode = dict(relu=relu, bn=bn)
    errs, repeat = {}, {}

    out, s, ss = fcbn.conv3x3_bn_fwd(x, *vecs, wt, **mode)
    _, s2, ss2 = fcbn.conv3x3_bn_fwd(x, *vecs, wt, **mode)
    repeat["conv3x3_bn_fwd"] = torch.equal(s, s2) and torch.equal(ss, ss2)
    ref, rs, rss = fcbn.conv3x3_bn_fwd_reference(x, *vecs, wt, **mode)
    of, rf = rows(out).float(), rows(ref).float()
    errs["conv3x3_bn_fwd"] = [
        prod_share(rows(out), rows(ref)),
        col_share(s, rs, FLBN_SUM_TOL * rf.abs().sum(dim=0)
                  + (of - rf).abs().sum(dim=0) + 1e-30),
        col_share(ss, rss, FLBN_SUM_TOL * (rf * rf).sum(dim=0)
                  + (of * of - rf * rf).abs().sum(dim=0) + 1e-30)]
    def middle_run(run):
        """The rows of the middle block's run of ``run`` pixels."""
        r0 = (-(-m // run) // 2) * run
        return slice(r0, r0 + run)

    # The limits must see sums that lack one block's run of pixels: the
    # middle block's, taken out of the kernel's own sums.
    gone = of[middle_run(fcbn.fwd_run_rows(m, w, cin, cout, tdt))].double()
    lost_run = {"conv3x3_bn_fwd": min(
        col_share((s.double() - gone.sum(dim=0)).float(), rs,
                  FLBN_SUM_TOL * rf.abs().sum(dim=0)
                  + (of - rf).abs().sum(dim=0) + 1e-30)[1],
        col_share((ss.double() - (gone * gone).sum(dim=0)).float(), rss,
                  FLBN_SUM_TOL * (rf * rf).sum(dim=0)
                  + (of * of - rf * rf).abs().sum(dim=0) + 1e-30)[1])}
    finite = bool(torch.isfinite(of).all())
    del out, ref, of, rf, s2, ss2, gone

    dx, db, dg = fcbn.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs, **mode)
    again = fcbn.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs, **mode)
    repeat["conv3x3_bn_bwd_dx"] = (torch.equal(db, again[1])
                                   and torch.equal(dg, again[2])) if bn \
        else None
    rdx, rdb, rdg = fcbn.conv3x3_bn_bwd_dx_reference(dy, y, ds, dss, wt, x,
                                                     *vecs, **mode)
    dyt = fcbn._dy_total(dy, y, ds, dss)
    errs["conv3x3_bn_bwd_dx"] = [prod_share(rows(dx), rows(rdx))]
    if bn:
        xh = rows((x.float() - mu) * inv)
        da = rows(fcbn._conv(dyt, wt.flip(2, 3).transpose(0, 1)))
        dz = torch.where(xh * gamma + beta > 0, da, 0.0) if relu else da
        limits = (FLBN_SUM_TOL * dz.abs().sum(dim=0) + 1e-30,
                  FLBN_SUM_TOL * (dz * xh).abs().sum(dim=0) + 1e-30)
        errs["conv3x3_bn_bwd_dx"] += [col_share(db, rdb, limits[0]),
                                      col_share(dg, rdg, limits[1])]
        run = middle_run(fcbn.bwd_dx_run_rows(m, w, cin, cout, tdt))
        lost_run["conv3x3_bn_bwd_dx"] = min(
            col_share((db.double() - dz[run].double().sum(dim=0)).float(),
                      rdb, limits[0])[1],
            col_share((dg.double() - (dz[run].double() * xh[run])
                       .sum(dim=0)).float(), rdg, limits[1])[1])
        del xh, da, dz, limits
    finite = finite and bool(torch.isfinite(dx.float()).all())
    del dx, again, rdx

    dw = fcbn.conv3x3_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode)
    repeat["conv3x3_bn_bwd_dw"] = torch.equal(
        dw, fcbn.conv3x3_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode))
    rdw = fcbn.conv3x3_bn_bwd_dw_reference(x, *vecs, dy, y, ds, dss, **mode)
    errs["conv3x3_bn_bwd_dw"] = [prod_share(dw_rows(dw), dw_rows(rdw))]
    # The limit must see a dw that lacks one of the kernel's chunks of M:
    # this one lacks the middle chunk's output pixels.
    chunk = -(-m // fcbn.dw_splits(m, cin, cout, tdt))
    r0 = min(m // 2, m - chunk)
    part = torch.zeros(m, cout, device=dev)
    part[r0:r0 + chunk] = rows(dyt)[r0:r0 + chunk].float()
    a = fcbn._prologue(x, *vecs, relu, bn).float().permute(0, 3, 1, 2)
    lost = torch.nn.grad.conv2d_weight(
        a, dw.shape, part.view(b, h, w, cout).permute(0, 3, 1, 2), padding=1)
    dropped = prod_share(dw_rows((dw.float() - lost).to(tdt)),
                         dw_rows(rdw))[1]
    finite = finite and bool(torch.isfinite(dw.float()).all())
    del dw, rdw, dyt, part, a, lost
    torch.cuda.synchronize()

    x4, dy4 = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    runs = {
        "conv3x3_bn_fwd": (
            lambda: fcbn.conv3x3_bn_fwd(x, *vecs, wt, **mode),
            lambda: fcbn.conv3x3_bn_fwd_reference(x, *vecs, wt, **mode),
            lambda: F.conv2d(x4, wt, padding=1)),
        "conv3x3_bn_bwd_dx": (
            lambda: fcbn.conv3x3_bn_bwd_dx(dy, y, ds, dss, wt, x, *vecs,
                                           **mode),
            lambda: fcbn.conv3x3_bn_bwd_dx_reference(dy, y, ds, dss, wt, x,
                                                     *vecs, **mode),
            lambda: torch.nn.grad.conv2d_input(x4.shape, wt, dy4,
                                               padding=1)),
        "conv3x3_bn_bwd_dw": (
            lambda: fcbn.conv3x3_bn_bwd_dw(x, *vecs, dy, y, ds, dss, **mode),
            lambda: fcbn.conv3x3_bn_bwd_dw_reference(x, *vecs, dy, y, ds,
                                                     dss, **mode),
            lambda: torch.nn.grad.conv2d_weight(x4, wt.shape, dy4,
                                                padding=1)),
    }
    rows_out = []
    for name, (kernel, plain, library) in runs.items():
        share = max(e[1] for e in errs[name])
        ok_repeat = repeat[name] is not False
        sees_drop = (name != "conv3x3_bn_bwd_dw" or dropped > 1.0) and \
            lost_run.get(name, 2.0) > 1.0
        bound, by = conv_bn_bound(name, b, h, w, cin, cout, bn, dtype)
        rows_out.append({
            "kernel": name, "b": b, "h": h, "w": w, "cin": cin,
            "cout": cout, "bn": bn, "relu": relu, "dtype": dtype,
            "max_abs_err": max(e[0] for e in errs[name]),
            "err_over_tol": share, "repeats": repeat[name],
            **({"dropped_chunk_over_tol": dropped}
               if name == "conv3x3_bn_bwd_dw" else {}),
            **({"lost_run_over_tol": lost_run[name]}
               if name in lost_run else {}),
            "ok": finite and share <= 1.0 and ok_repeat and sees_drop,
            "ms": device_ms(kernel), "plain_ms": device_ms(plain),
            "library_ms": device_ms(library), "bound_ms": bound,
            "bound_by": by})
    return rows_out


def phase_conv_bn_grid(fcbn, failures) -> dict:
    """Kernels #11-#13 over the four (B, H, W, C) shapes of ResNet-50's 13
    stride-1 3x3 convolutions at batch 512, with the prologue and ReLU, and
    one small row without the prologue (Cin != Cout), in bf16 (the training
    path's dtype) and f32. Returns {dtype: {variant: rows by kernel}}, logs
    each row, and for bf16 each kernel's time summed over one step's 13
    layers."""
    import torch

    layers = resnet50_conv3_layers()
    variants = [(*v, v[-1], True, True) for v in sorted(set(layers))]
    variants.append((8, 28, 28, 64, 128, False, False))
    grid = {}
    seed = SEED + 60
    for dtype in ("bfloat16", "float32"):
        grid[dtype] = {}
        for v in variants:
            seed += 1
            rows = conv_bn_case(fcbn, *v, dtype, seed)
            grid[dtype][v] = {r["kernel"]: r for r in rows}
            for r in rows:
                log("# conv_bn_grid " + json.dumps(r))
                if not r["ok"]:
                    failures.append(f"{r['kernel']} disagrees with its plain "
                                    f"version or does not repeat, or its "
                                    f"limit passes a lost chunk or run: "
                                    f"{r}")
            torch.cuda.empty_cache()
    step = {}
    for name in ("conv3x3_bn_fwd", "conv3x3_bn_bwd_dx", "conv3x3_bn_bwd_dw"):
        step[name] = {key: sum(grid["bfloat16"][(*v, v[-1], True, True)]
                               [name][key] for v in layers)
                      for key in ("ms", "bound_ms", "plain_ms",
                                  "library_ms")}
    log("# conv_bn_grid one ResNet-50 step (13 layers, bf16, batch 512), "
        "summed ms by kernel: " + json.dumps(step))
    # The main row: stage 1's 3x3, the prologue and ReLU on.
    return {"grid": grid, "step": step,
            "main": (*layers[0], layers[0][-1], True, True)}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs the card",
              file=sys.stderr)
        return 1
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa
    from distributeddeeplearning_tpu_torch.ops import fused_batchnorm as bn
    from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as fcbn
    from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as flbn

    # Full-f32 references: no TF32 in the plain versions' products.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    csrc = "distributeddeeplearning_tpu_torch/csrc/"
    replaces = "distributeddeeplearning_tpu/ops/flash_attention.py:"
    replaces_bn = "distributeddeeplearning_tpu/ops/fused_batchnorm.py:"
    replaces_lb = "distributeddeeplearning_tpu/ops/fused_linear_bn.py:"
    replaces_cb = "distributeddeeplearning_tpu/ops/fused_conv_bn.py:"
    kernels = [
        {"name": "flash_attention_fwd", "counter": "launches",
         "module": fa, "build": fa.SOURCE, "replaces": replaces + "101"},
        {"name": "flash_attention_dq", "counter": "dq_launches",
         "module": fa, "build": fa.BWD_SOURCE, "replaces": replaces + "209"},
        {"name": "flash_attention_dkv", "counter": "dkv_launches",
         "module": fa, "build": fa.BWD_SOURCE, "replaces": replaces + "261"},
        {"name": "bn_stats", "counter": "stats_launches", "module": bn,
         "build": bn.SOURCE, "replaces": replaces_bn + "147"},
        {"name": "bn_apply", "counter": "apply_launches", "module": bn,
         "build": bn.SOURCE, "replaces": replaces_bn + "198"},
        {"name": "bn_bwd_reduce", "counter": "bwd_reduce_launches",
         "module": bn, "build": bn.SOURCE, "replaces": replaces_bn + "256"},
        {"name": "bn_bwd_dx", "counter": "bwd_dx_launches", "module": bn,
         "build": bn.SOURCE, "replaces": replaces_bn + "331"},
        {"name": "linear_bn_fwd", "counter": "fwd_launches", "module": flbn,
         "build": flbn.SOURCE, "replaces": replaces_lb + "65"},
        {"name": "linear_bn_bwd_dx", "counter": "bwd_dx_launches",
         "module": flbn, "build": flbn.SOURCE,
         "replaces": replaces_lb + "136"},
        {"name": "linear_bn_bwd_dw", "counter": "bwd_dw_launches",
         "module": flbn, "build": flbn.SOURCE,
         "replaces": replaces_lb + "216"},
        {"name": "conv3x3_bn_fwd", "counter": "fwd_launches", "module": fcbn,
         "build": fcbn.SOURCE, "replaces": replaces_cb + "130"},
        {"name": "conv3x3_bn_bwd_dx", "counter": "bwd_dx_launches",
         "module": fcbn, "build": fcbn.SOURCE,
         "replaces": replaces_cb + "201"},
        {"name": "conv3x3_bn_bwd_dw", "counter": "bwd_dw_launches",
         "module": fcbn, "build": fcbn.SOURCE,
         "replaces": replaces_cb + "296"},
    ]
    for k in kernels:
        k.update(route="cuda", source=csrc + k["build"])
    failures: list[str] = []
    scratch = ROOT / ".cache" / "chip_smoke"
    scratch.mkdir(parents=True, exist_ok=True)
    t_start = time.perf_counter()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        log(f"# phase {name}: {time.perf_counter() - t0:.2f} s")
        return out

    try:
        timed("card", phase_card)
        timed("build", phase_build, kernels)
        timed("flash_grid", phase_flash_grid, fa, failures)
        timed("gpt2_sampling", phase_gpt2, kernels, failures, scratch)
        timed("llama", phase_llama, fa, failures)
        timed("bwd_grid", phase_bwd_grid, fa, failures)
        main_rows = timed("train_rows", phase_train_rows, fa)
        timed("bwd_repeat", phase_bwd_repeat, fa, failures)
        train = timed("gpt2_train", phase_train, kernels, failures)
        timed("flash_vs_dense_step", phase_flash_vs_dense_step, failures)
        bn_grid = timed("bn_grid", phase_bn_grid, bn, failures)
        resnet = timed("resnet_train", phase_resnet_train, kernels, failures,
                       ["--fused-bn"], {bn: RESNET_BN_LAYERS},
                       ("bn", BN_KERNELS))
        timed("fused_vs_unfused_step", phase_fused_vs_unfused_step,
              failures, {"fused_bn": {"fused_bn": True}})
        lb_grid = timed("linear_bn_grid", phase_linear_bn_grid, flbn,
                        failures)
        block = timed("resnet_fused_block_train", phase_resnet_train,
                      kernels, failures, ["--fused-block"],
                      {flbn: RESNET_LINEAR_LAYERS},
                      ("linear_bn", FLBN_KERNELS))
        unfused = timed("resnet_unfused_step", resnet_step_profile, [],
                        ("bn", BN_KERNELS))
        cb_grid = timed("conv_bn_grid", phase_conv_bn_grid, fcbn, failures)
        conv3 = timed("resnet_fused_conv3_train", phase_resnet_train,
                      kernels, failures, ["--fused-block", "--fused-conv3"],
                      {flbn: RESNET_LINEAR_LAYERS, fcbn: RESNET_CONV3_LAYERS},
                      ("fused_block", FLBN_KERNELS + FCBN_KERNELS))
        log("# resnet50 A/B, one bf16 step at batch 512 (wall us, busy us): "
            + json.dumps({name: [p.get("wall_us"), p.get("device_busy_us")]
                          for name, p in (
                              ("unfused", unfused),
                              ("--fused-bn", resnet["profile"]),
                              ("--fused-block", block["profile"]),
                              ("--fused-block --fused-conv3",
                               conv3["profile"]))}))
        timed("fused_block_vs_unfused_step", phase_fused_vs_unfused_step,
              failures, {"fused_block": {"fused_block": True},
                         "fused_block+fused_conv3": {
                             "fused_block": True, "fused_conv3": True}})
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"# total: {time.perf_counter() - t_start:.2f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    # Flash rows: the GPT-2 training shape, launches from its training run.
    # BatchNorm rows: the stem's shape (6,422,528 x 64, bf16, relu),
    # launches from the ResNet-50 --fused-bn run, and ``step_ms``: the
    # kernel's time summed over one step's 53 layers. Matmul rows: stage 1's
    # conv3 (1,605,632 x 64 -> 256, bf16, prologue and ReLU), launches from
    # the --fused-block run, ``step_ms`` summed over its 36 layers. 3x3
    # rows: stage 1's 3x3 (512 x 56 x 56, 64 -> 64, bf16, prologue and
    # ReLU), launches from the --fused-block --fused-conv3 run, ``step_ms``
    # summed over its 13 layers.
    stem = bn_grid["grid"]["bfloat16"][bn_grid["stem"]]
    lin_main = lb_grid["grid"]["bfloat16"][lb_grid["main"]]
    conv_main = cb_grid["grid"]["bfloat16"][cb_grid["main"]]
    kernel_rows = []
    for k in kernels:
        if k["module"] is fa:
            row, launches = main_rows[k["name"]], train["launches"]
            extra = {key: row[key] for key in ("library_rate", "ms_rate0",
                                               "library_call_ms")
                     if key in row}
        elif k["module"] is bn:
            row, launches = stem[k["name"]], resnet["launches"]
            extra = {"step_ms": bn_grid["step"][k["name"]]["ms"]}
        elif k["module"] is flbn:
            row, launches = lin_main[k["name"]], block["launches"]
            extra = {"step_ms": lb_grid["step"][k["name"]]["ms"]}
        else:
            row, launches = conv_main[k["name"]], conv3["launches"]
            extra = {"step_ms": cb_grid["step"][k["name"]]["ms"]}
        kernel_rows.append({
            "name": k["name"], "route": k["route"], "source": k["source"],
            "replaces": k["replaces"], "launches": launches[k["name"]],
            **{key: row[key] for key in ("max_abs_err", "ms", "plain_ms",
                                         "bound_ms", "bound_by",
                                         "library_ms")},
            **extra})
    log(json.dumps({"kernels": kernel_rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description="Smoke run of the PyTorch port on one NVIDIA GPU; with "
        "no arguments, every phase.")
    parser.add_argument(
        "--step-ab", metavar="CHECKOUT", nargs="+",
        help="only time one GPT-2 small training step (the training path's "
        "configuration) with the flash backward kernels, and one bf16 "
        "ResNet-50 --fused-block --fused-conv3 step at batch 512 with the "
        "3x3 and 1x1 conv+BatchNorm kernels, with the port of one CHECKOUT "
        "and of another (default: this one), in turns (first, second, "
        "second, first), each in a process of its own")
    parser.add_argument("--gpt2-step", metavar="CHECKOUT",
                        help=argparse.SUPPRESS)
    parser.add_argument("--resnet-step", metavar="CHECKOUT",
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


if __name__ == "__main__":
    cli = parse_args(sys.argv[1:])
    if cli.gpt2_step:
        sys.exit(gpt2_step(cli.gpt2_step))
    if cli.resnet_step:
        sys.exit(resnet_step(cli.resnet_step))
    if cli.step_ab:
        if len(cli.step_ab) > 2:
            sys.exit("--step-ab takes one or two checkouts")
        sys.exit(step_ab(cli.step_ab[0], (cli.step_ab[1:] or [str(ROOT)])[0]))
    sys.exit(main())
