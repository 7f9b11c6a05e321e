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
   batch, held as phase 12 (one f64 step serves both);
18. the DenseNet path: ``python -m distributeddeeplearning_tpu_torch.train
   --config densenet121_dp --dp 1 --batch-size 256 --synthetic --precision
   mixed --ema-decay 0.999 --eval-batches 2`` for a few steps (DenseNet-121
   uncut, 224x224, 1000 classes, bf16 over f32 masters, dynamic loss
   scaling, sgd as the preset sets it); its BatchNorm is plain, so no
   kernel of the port may launch; every loss finite and the first near
   ln(1000), ``loss_scale`` reported, ``eval_top1`` in [0, 1]; images/s,
   peak memory and a device-time profile of one step;
19. the large-batch ResNet path: ResNet-50 ``--fused-block --fused-conv3
   --precision mixed --optimizer lars --ema-decay 0.999 --batch-ramp
   256:3,512 --batch-size 512`` with checkpoints every 3 steps and one eval
   batch, 6 steps; #8-#10 36 and #11-#13 13 launches a training step (the
   eval forwards launch none), no other kernel; losses finite, at most one
   loss-scale skip, each step's lr its stage's schedule; images/s a stage
   and a device-time profile of one step at batch 512;
20. one f32 step of ResNet-50 at batch 32 with loss scale 2^15 and without,
   same weights and batch, with ``fused_bn`` and with ``fused_block`` +
   ``fused_conv3``: the unscaled gradients and running buffers must equal
   the unscaled step's bit for bit (or within 2^-20 of a tensor's largest
   |ref|, each such tensor printed);
21. data parallelism on one card: ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m distributeddeeplearning_tpu_torch.
   train --model resnet50 --batch-size 512 --synthetic --fused-block
   --fused-conv3 --sync-bn --dp 1`` for 6 steps, an NCCL group of one
   process; #8-#10 36 and #11-#13 13 launches a step (the worker's own
   counts, from its summary), no other kernel; losses finite, the first
   within 0.3 of ln 1000; steps 1-2 profiled in the worker, where every
   bucket of the plan (``plan_buckets`` of ResNet-50's parameters at 4 MB)
   must run its ``allreduce/bucketNN`` once a step and no other bucket
   runs; images/s, peak memory, the buckets' device ms. Then one f32 step
   of ResNet-50 ``fused_block`` + ``fused_conv3`` at batch 32 through the
   data-parallel step with sync BN (world 1, NCCL, in this process) against
   the one-card step from the same weights and batch: the loss, every
   gradient and running buffer and every updated parameter bit for bit (a
   one-rank sum and a division by 1 are exact; cuDNN deterministic). NCCL
   refuses two ranks on one GPU, so no world above 1 runs on one card:
   those are held on the CPU with gloo (``tests/test_torch_dp.py``);
22. the real 32k LARS update: ``--config resnet50_lars_32k --dp 1 --accum
   64 --fused-block --fused-conv3`` for 2 updates, each 64 microbatches of
   512 (global batch 32,768, bf16, LARS at the preset's lr); #8-#10 launch
   36 x 64 and #11-#13 13 x 64 times an update, no other kernel; losses
   finite; each lr the preset schedule's at the update count; the peak
   memory less the global batch's images is within 10% of one batch-512
   update's less its images (measured first, same flags, ``--accum 1``);
   images/s of the timed update;
23. (left out: an image folder through the C++ loader needs libjpeg's
   headers and library, which the card's machine lacks; the loader is held
   on the CPU, ``tests/test_torch_native_loader.py``);
24. real data on the card: token shards (``train-00000.npy`` of uint16 ids,
   ``train-00001.npy`` of int32, written here with numpy) through
   ``python -m distributeddeeplearning_tpu_torch.train --model gpt2_small
   --batch-size 16 --seq-len 1024 --attn flash --data-dir SHARDS`` for 6
   steps; ``loader=tokens`` in the log and the summary, #1-#3 12 launches a
   step and no other kernel, losses finite and the first within 0.5 of
   ln(vocab); tokens/s and the stream-wait share beside phase 8's
   synthetic run. Then the host-to-card stream itself: the token source on
   the card must hand out the host stream's batches exactly, and a stream
   of ResNet-50-sized float32 image batches (512 x 224 x 224 x 3, made
   with numpy; no decode) through pinned memory, the side stream's copy
   and the cast to bf16, with the images/s it delivers and the device
   memory it holds;
25. BERT-base masked-LM on the card: ``python -m
   distributeddeeplearning_tpu_torch.train --config bert_base_mlm --dp 1
   --attn flash`` for 6 steps at the preset's 256 x 128 (bf16 over f32
   masters, AdamW, dropout 0.1), on synthetic batches with the dense head,
   then on token shards written here with PAD tails of varied length
   (the key-padding mask live) and ``--mlm-max-predictions -1``; each
   run: #1-#3 12 launches a step and no other kernel, losses finite and
   the first within 0.5 of ln 30522; tokens/s, peak memory and a
   device-time profile of one step. Before it, the flash kernels at
   BERT-base's shape (256 x 128, 12 heads of 64, full, key padding, rate
   0.1) and ViT-B/16's (256 x 197, full, rate 0) against their plain
   versions, with their times, bounds and SDPA's;
26. ViT-B/16 on the card: ``--model vit_b16 --batch-size 256 --synthetic
   --attn flash`` for 6 steps (224 px, S = 197, 1000 classes, bf16); #1-#3
   12 launches a step and no other kernel, losses finite and the first
   within 0.3 of ln 1000; images/s, peak memory and the profile;
27. one f32 training step at full width through flash and through dense
   from the same weights and batch, held as phase 9: BERT-base at batch 8
   x 128 with padded keys and dropout 0.1, and ViT-B/16 at batch 8;
28. token models on the data axis: ``python -m torch.distributed.run
   --standalone --nproc-per-node 1 -m distributeddeeplearning_tpu_torch.
   train --config bert_base_mlm --dp 1 --accum 8 --attn flash
   --synthetic`` for 4 steps, the preset's global batch of 256 as 8
   microbatches of 32 x 128 (the per-chip shape of its own ``--dp 8``) in
   an NCCL group of one; #1-#3 12 x 8 launches a step each (the worker's
   counts, from its summary), no other kernel; losses finite and the
   first within 0.5 of ln 30522; tokens/s, peak memory and a device-time
   profile of one step. Then one BERT-base step (bf16, flash, dropout 0.1,
   batch 32 x 128 with PAD tails, ``--accum 2``) through the
   data-parallel step (world 1, NCCL, in this process) against the
   one-card step from the same weights and batch: the loss, every gradient
   and every updated parameter bit for bit. Then one f32 step of GPT-2
   small (flash, dropout 0) at batch 8 x 1024 with ``--accum 2`` against
   ``--accum 1`` on the same batch: the loss within 1e-5 and every
   gradient within 1e-4 of its tensor's largest |ref| (floored at 1e-4 of
   the largest of all). A world above 1 is held on the CPU with gloo only
   (``tests/test_torch_token_dp.py``);
29. serving: ``python -m distributeddeeplearning_tpu_torch.serve`` with
   GPT-2 small uncut in float32 (seeded weights as a flax-layout ``.npz``),
   32 slots, 1024 pages of 16 tokens (1.21 GB of pools), prefill buckets
   64-512 and the radix prefix cache, over 48 requests made from the seed
   (prompts of 32-512 tokens, 8-64 new tokens, arrivals over the first
   second, half of them behind one 256-token head); exit 0, every request
   finished, the leak check held, at least one prefix hit and one copy on
   write, no kernel of the port launched; each request's tokens equal to
   ``generate(use_cache=True)`` of it alone, or parted at a tie (the
   reference's top two logits within 1e-4 of its largest |logit|, printed
   with its gap); tokens/s, TTFT and inter-token p50/p99, peak memory, the
   largest page occupancy, the engine's counters and a device-time profile
   of the decode step at 32 live slots. Then the preemption run on
   TinyLlama-1.1B's widths at 2 layers (the JAX engine test's shape: a
   tenant's page cap tightened mid-run, a starved request): at least one
   preemption, both requests equal to ``generate(use_cache=True)``. The
   serve path runs no kernel of its own: its paged attention is plain
   PyTorch, as the JAX engine's is jnp code;
30. speculative serving: phase 29's config and requests with ``spec_k`` 4
   and a drafter of GPT-2 small's widths at 2 layers (1024 positions,
   weights from the seed + 1) passed to the engine (the registry's gpt_nano
   holds 128 positions, fewer than a slot's 1024 tokens, and is refused):
   the leak check held, no kernel launched, every request equal to
   ``generate(use_cache=True)`` but at a tie; the speculative counters,
   tokens/s, TTFT and inter-token p50/p99. Then the self-draft through the
   entry point over 8 of the requests, target and drafter both the
   registry's GPT-2 small from the config's seed (no ``--params``):
   accepted over proposed at least 0.95, every request equal to
   ``generate(use_cache=True)`` of the same registry model but at a tie.
   Then the preemption run with a drafter of TinyLlama's widths at 1 layer
   and ``spec_k`` 3: it must preempt and stay equal;
31. traced serving: phase 29's run again with ``--serve-trace-dir``: the
   merged trace loads with no error, every ``serve:*`` name in it is
   registered (``serve/tracing.py``), every finished request's attribution
   sums to its latency and its TTFT within 1 ms, no kernel launched, every
   request equal to ``generate(use_cache=True)`` but at a tie; the p50/p99
   of each TTFT and latency component, and tokens/s beside phase 29's
   untraced rate (tracing's cost, not gated);
32. beam and speculative generation: GPT-2 small in float32 through
   ``python -m distributeddeeplearning_tpu_torch.generate``, 2 prompts x
   64 tokens, ``--num-beams 4``, 32 new tokens, by KV cache, by dense
   refeed and by refeed through the flash kernel (#1 launched 12 x 32 times,
   no other kernel): the ids equal, or parted where the two candidates'
   summed log-probabilities through the parting step lie within 1e-4 (a
   tie, printed); then ``--draft-model gpt_nano --draft-len 4`` with seeded
   gpt_nano weights (``--draft-params``), each prompt's ids equal to greedy
   ``generate``'s but at a tie.

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

    python3 chip_smoke.py --serve-ab CHECKOUT [OTHER]

runs none of that either: it serves phase 29's requests through the serve
entry point three times with the port of CHECKOUT and of OTHER, each in a
process of its own, in the same turns; where a checkout has them, each
untraced run is followed by a traced run (``--serve-trace-dir``) and a
speculative run (phase 30's drafter), so that tracing's and speculation's
cost are read within one process. It prints each run's tokens/s, window,
TTFT and inter-token p50/p99, and each kind's median tokens/s.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import shutil
import signal
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
# DenseNet training path: DenseNet-121 at full width through the
# densenet121_dp preset on one card, bf16 over f32 masters with dynamic loss
# scaling, EMA and a held-out eval. Its BatchNorm is plain (the JAX DenseNet
# has no fused path), so no kernel of the port may launch.
DENSE_ARGV = ["--config", "densenet121_dp", "--dp", "1", "--batch-size",
              "256", "--synthetic", "--precision", "mixed", "--ema-decay",
              "0.999", "--eval-batches", "2", "--steps", str(RESNET_STEPS),
              "--log-every", "1", "--seed", str(SEED)]
# The large-batch ResNet path: --fused-block --fused-conv3 under mixed
# precision, LARS, EMA and a two-stage batch ramp chained through
# checkpoints, one held-out batch evaluated at the end of each stage. A
# stage's timing skips its first step.
RAMP_STAGE_STEPS = 3
RAMP_FLAGS = ["--fused-block", "--fused-conv3", "--precision", "mixed",
              "--optimizer", "lars", "--ema-decay", "0.999"]
RAMP_ARGV = ["--model", "resnet50", *RAMP_FLAGS, "--batch-ramp",
             f"{RESNET_BATCH // 2}:{RAMP_STAGE_STEPS},{RESNET_BATCH}",
             "--batch-size", str(RESNET_BATCH), "--checkpoint-every",
             str(RAMP_STAGE_STEPS), "--eval-batches", "1", "--steps",
             str(2 * RAMP_STAGE_STEPS), "--synthetic", "--log-every", "1",
             "--warmup-steps", "1", "--seed", str(SEED)]
# Data parallelism on one card (phase 21): the training CLI under torchrun,
# one NCCL rank, sync BN through #8-#13; steps 1-2 profiled (within the
# three untimed warm-up steps).
DP_PROFILED = (1, 3)
DP_ARGV = ["--model", "resnet50", "--batch-size", str(RESNET_BATCH),
           "--synthetic", "--fused-block", "--fused-conv3", "--sync-bn",
           "--dp", "1", "--steps", str(RESNET_STEPS), "--log-every", "1",
           "--seed", str(SEED), "--warmup-steps", "3", "--profile-steps",
           ",".join(map(str, DP_PROFILED))]
DP_TIMEOUT_S = 600
# The 32k LARS update (phase 22): the preset's 32,768 images an update as 64
# microbatches of 512 on one card.
LARS_ACCUM, LARS_UPDATES = 64, 2
LARS_FLAGS = ["--config", "resnet50_lars_32k", "--dp", "1", "--fused-block",
              "--fused-conv3", "--synthetic", "--log-every", "1", "--seed",
              str(SEED)]
# Peak memory less the step's images may exceed one batch-512 update's by
# this share.
LARS_MEMORY_SLACK = 0.10
# Loss scale 2^15 against none, one f32 step at batch 32: every backward
# kernel is linear in dy and a power-of-two scale is exact, so the
# unscaled gradients and the running buffers should equal the unscaled
# step's bit for bit; a tensor that does not may differ by at most this
# share of its largest |ref|.
SCALED_STEP_TOL = 2.0 ** -20


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


def backward_ms(forward, inputs, grad_out) -> float:
    """Mean device time of autograd's backward of ``forward()`` to
    ``inputs`` (leaf tensors) with ``grad_out``: the forward captured in
    one CUDA graph and the backward in a second on the same stream and
    memory pool, as ``torch.cuda.make_graphed_callables`` captures them,
    and the backward graph replayed. No profiler: its records of the
    backward came back empty or incomplete in some runs on the card."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as graphs want
        for _ in range(2):
            torch.autograd.grad(forward(), inputs, grad_out)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    fwd_graph, bwd_graph = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
    with torch.cuda.graph(fwd_graph):
        out = forward()
    with torch.cuda.graph(bwd_graph, pool=fwd_graph.pool()):
        torch.autograd.grad(out, inputs, grad_out, retain_graph=True)
    fwd_graph.replay()
    bwd_graph.replay()
    torch.cuda.synchronize()
    per_call = max(_events_ms(bwd_graph.replay, 1), 1e-3)
    ms = _events_ms(bwd_graph.replay,
                    int(min(200, max(3, MIN_TOTAL_MS / per_call))))
    del fwd_graph, bwd_graph, out
    return ms


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
    # torch.cat's copies (DenseNet's concatenations).
    ("concat", ("catarraybatchedcopy",)),
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
        # The optimizer's record_function range is mirrored onto the device
        # timeline as an annotation spanning its kernels: not a kernel.
        if getattr(e, "is_user_annotation", False) or e.name.startswith(
                "Optimizer."):
            continue
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
        dot = do.transpose(1, 2)
        lib_bwd = backward_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=keep), (qt, kt, vt), dot)
        out = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=keep)
        lib_bwd_call = call_ms(lambda: torch.autograd.grad(
            out, (qt, kt, vt), dot, retain_graph=True))
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


def model_step_profile(label: str, argv, per_example: int) -> dict:
    """A device-time profile of one training step of a CLI configuration
    (``step_profile``) on its source's first batch, with the examples
    (``per_example`` = 1) or tokens (the sequence length) a second of its
    unprofiled wall time and the peak device memory."""
    import torch

    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop, steps

    config = train_cli.build_config(train_cli.parse_args(argv))
    state, sched = loop.build_state(config, torch.device("cuda"))
    train_step = steps.make_train_step(config, sched)
    source = loop.make_source(config, state.model, torch.device("cuda"))
    batch = source.batch(0)
    torch.cuda.reset_peak_memory_stats()
    profile = step_profile(label, lambda: train_step(state, batch),
                           grad=True)
    profile["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    unit = "tokens" if per_example > 1 else "images"
    if profile.get("wall_us"):
        profile[f"{unit}_per_sec"] = (config.global_batch_size * per_example
                                      / profile["wall_us"] * 1e6)
    log(f"# {label}: peak memory {profile['peak_memory_gb']:.2f} GB, "
        f"{profile.get(f'{unit}_per_sec')} {unit}/s")
    del state, batch
    torch.cuda.empty_cache()
    return profile


def run_path(label: str, kernels, argv, failures, *, steps: int,
             per_step: int, first: float, first_tol: float,
             rate: str = "examples_per_sec") -> dict:
    """One training CLI run with the port's counts set to 0 just before it
    and read just after: ``steps`` losses, each flash kernel launched
    ``per_step`` x ``steps`` times and no other kernel of the port, every
    loss finite and the first within ``first_tol`` of ``first``, and the
    summary's ``rate``. Returns the record."""
    import torch

    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    torch.cuda.empty_cache()
    reset_counts(kernels)
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        lines = run_train_cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    metrics, _, summary = split_lines(lines)
    losses = [x["loss"] for x in metrics]
    expected = {k["name"]: per_step * steps if k["module"] is fa else 0
                for k in kernels}
    record = {"cli_s": cli_s, "launches": launches, "losses": losses,
              "log": [x for x in err.getvalue().splitlines()
                      if "loader=" in x],
              "summary": summary}
    if launches != expected:
        failures.append(f"{label}: launches {launches}, expected "
                        f"{expected}")
    if (len(losses) != steps or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - first) > first_tol):
        failures.append(f"{label}: losses {losses}; need {steps} finite, "
                        f"the first within {first_tol} of {first:.4f}")
    if not summary.get(rate):
        failures.append(f"{label}: summary without {rate}: {summary}")
    log(f"# {label}: " + json.dumps(record))
    return record


def phase_train(kernels, failures) -> dict:
    """The training path: GPT-2 small at full width through the CLI
    (``run_path``), then a device-time profile of one step of the same
    configuration."""
    record = run_path("gpt2_small train", kernels, TRAIN_ARGV, failures,
                      steps=TRAIN_STEPS, per_step=12,
                      first=float(np.log(VOCAB)), first_tol=FIRST_LOSS_TOL,
                      rate="tokens_per_sec")
    record["profile"] = gpt2_step_profile()
    return record


def gpt2_step_profile() -> dict:
    """A device-time profile of one step of the training path's
    configuration, with its tokens/s and peak device memory
    (``model_step_profile``)."""
    return model_step_profile("gpt2_small train step (bf16, flash, "
                              "dropout 0.1)", TRAIN_ARGV, TRAIN_SEQ)


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
    draw the same device generators). Loss and every gradient compared
    (``flash_vs_dense_step``)."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.losses import (
        causal_lm_loss)
    from distributeddeeplearning_tpu_torch.train.steps import dropout_rng

    ids = torch.as_tensor(np.random.default_rng(SEED + 5).integers(
        1, VOCAB, (DENSE_BATCH, TRAIN_SEQ)), device="cuda")
    flash_vs_dense_step(
        f"gpt2_small (batch {DENSE_BATCH} x {TRAIN_SEQ}, dropout 0.1)",
        lambda impl: get_model("gpt2_small", dtype=torch.float32,
                               attention_impl=impl).train(),
        lambda m: causal_lm_loss(m(ids, rng=dropout_rng(SEED, 0)), ids),
        failures, SEED + 6)


def worst_grad_err(out: dict, ref: dict) -> tuple[float, str]:
    """The largest error of a gradient of ``out`` against ``ref`` (by
    name), each relative to max(its largest |ref|, 1e-4 of the largest of
    all), and its name."""
    top = max(g.abs().max().item() for g in ref.values())
    worst, worst_name = 0.0, None
    for name, r in ref.items():
        scale = max(r.abs().max().item(), 1e-4 * top)
        err = (out[name] - r).abs().max().item() / scale
        if err >= worst:
            worst, worst_name = err, name
    return worst, worst_name


def flash_vs_dense_step(label, build, forward, failures, seed) -> dict:
    """One f32 training step of the model ``build(impl)`` gives, its
    weights drawn after ``torch.manual_seed(seed)``, through flash and
    through dense from the same weights, on ``forward(model)``'s loss: the
    loss within STEP_LOSS_TOL and each gradient within STEP_GRAD_TOL of
    max(its largest |ref|, 1e-4 of the largest of all; a gradient zero in
    exact arithmetic, such as the key bias's, holds only rounding)."""
    import torch

    grads, losses = {}, {}
    state = None
    torch.manual_seed(seed)
    for impl in ("flash", "dense"):
        model = build(impl)
        if state is None:
            state = model.state_dict()
        else:
            model.load_state_dict(state)
        loss = forward(model)
        loss.backward()
        losses[impl] = loss.item()
        grads[impl] = {n: p.grad for n, p in model.named_parameters()}
        del model, loss
    worst, worst_name = worst_grad_err(grads["flash"], grads["dense"])
    loss_err = abs(losses["flash"] - losses["dense"])
    record = {"losses": losses, "loss_err": loss_err, "worst_grad_err": worst,
              "worst_grad": worst_name}
    log(f"# {label} f32 train step, flash vs dense: " + json.dumps(record))
    if not np.isfinite(loss_err) or loss_err > STEP_LOSS_TOL \
            or not worst <= STEP_GRAD_TOL:
        failures.append(f"{label} flash vs dense step: loss err {loss_err}, "
                        f"gradient err {worst} ({worst_name})")
    del grads
    torch.cuda.empty_cache()
    return record


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


def cli_step_profile(argv, label, focus) -> dict:
    """A device-time profile of one training step of the configuration the
    training CLI builds from ``argv``, from the seeded state, and the peak
    memory of that step."""
    import torch

    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop, steps

    config = train_cli.build_config(train_cli.parse_args(argv))
    state, sched = loop.build_state(config, torch.device("cuda"))
    train_step = steps.make_train_step(config, sched)
    batch = loop.make_source(config, state.model, "cuda").batch(0)
    torch.cuda.reset_peak_memory_stats()
    profile = step_profile(label, lambda: train_step(state, batch),
                           grad=True, focus=focus)
    profile["peak_memory_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del state, batch
    torch.cuda.empty_cache()
    return profile


def split_lines(lines) -> tuple[list, list, dict]:
    """A training CLI's output as (metric lines, eval lines, summary)."""
    metrics = [x for x in lines if "step" in x and "loss" in x]
    evals = [x for x in lines if "step" in x and "loss" not in x]
    return metrics, evals, lines[-1].get("summary", {})


def phase_densenet_train(kernels, failures) -> dict:
    """Phase 18, the DenseNet path: DenseNet-121 at full width (224x224,
    1000 classes, batch 256) through the ``densenet121_dp`` preset on one
    card with ``--precision mixed --ema-decay 0.999 --eval-batches 2``.
    Its BatchNorm is plain, so every counter of the port must stay 0;
    every loss finite, the first within RESNET_FIRST_LOSS_TOL of ln 1000,
    ``loss_scale`` reported, ``eval_top1`` in [0, 1]. Then images/s, peak
    memory and a device-time profile of one step (cuDNN convolutions,
    concatenation copies, the plain BatchNorm's elementwise and reduction
    glue)."""
    import torch

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    lines = run_train_cli(DENSE_ARGV)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    metrics, evals, summary = split_lines(lines)
    losses = [x["loss"] for x in metrics]
    log(f"# densenet121 mixed train: CLI {cli_s:.2f} s, launches "
        f"{launches}, losses {losses}, loss scales "
        f"{[x.get('loss_scale') for x in metrics]}, peak memory "
        f"{peak_gb:.2f} GB, summary {json.dumps(summary)}")
    if any(launches.values()):
        failures.append(f"DenseNet path launched kernels of the port: "
                        f"{launches}")
    if (len(losses) != RESNET_STEPS
            or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - np.log(RESNET_CLASSES))
            > RESNET_FIRST_LOSS_TOL):
        failures.append(f"DenseNet losses {losses}: need {RESNET_STEPS} "
                        f"finite, the first within {RESNET_FIRST_LOSS_TOL} "
                        f"of ln {RESNET_CLASSES}")
    if not all("loss_scale" in x for x in metrics):
        failures.append("DenseNet metric lines without loss_scale")
    top1 = summary.get("eval_top1")
    if top1 is None or not 0.0 <= top1 <= 1.0 or not summary.get(
            "examples_per_sec"):
        failures.append(f"DenseNet summary without eval_top1 in [0, 1] or "
                        f"images/s: {summary}")
    profile = cli_step_profile(
        DENSE_ARGV, "densenet121 train step (bf16, mixed, EMA, batch 256)",
        ("concat", ("CatArrayBatchedCopy",)))
    return {"summary": summary, "peak_memory_gb": peak_gb,
            "profile": profile, "losses": losses}


def phase_large_batch(kernels, failures) -> dict:
    """Phase 19, the large-batch ResNet path: ResNet-50 ``--fused-block
    --fused-conv3 --precision mixed --optimizer lars --ema-decay 0.999``
    with the ramp 256 x 3 steps, then 512 x 3, chained through a
    checkpoint, one eval batch at the end of each stage. #8-#10 must launch
    36 and #11-#13 13 times for each of the 6 training steps (a step the
    scaler skips still runs its forward and backward); the eval forwards run
    in eval mode, which is the plain composition and launches none; no
    other kernel. Every loss finite, at most one loss-scale skip, and each
    step's lr the port's schedule of its stage (the stage's batch over the
    horizon of its end) at the update count. Then a device-time profile of
    one step of this configuration at batch 512, beside the sgd step of the
    ``--fused-block --fused-conv3`` phase."""
    import torch

    from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as fcbn
    from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as flbn
    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop

    steps_total = 2 * RAMP_STAGE_STEPS
    ckpt_dir = ROOT / ".cache" / "chip_smoke" / "ramp_ckpt"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    argv = [*RAMP_ARGV, "--checkpoint-dir", str(ckpt_dir)]
    per_step = {flbn: RESNET_LINEAR_LAYERS, fcbn: RESNET_CONV3_LAYERS}
    expected = {k["name"]: per_step.get(k["module"], 0) * steps_total
                for k in kernels}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    lines = run_train_cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    metrics, evals, summary = split_lines(lines)
    losses = [x["loss"] for x in metrics]
    skips = [x.get("loss_scale_skip", 0.0) for x in metrics]
    # The lr each step should have used: stage k's schedule at the number
    # of updates applied before it.
    config = train_cli.build_config(train_cli.parse_args(argv))
    want, updates = [], 0
    for x, skip in zip(metrics, skips):
        stage = 0 if x["step"] <= RAMP_STAGE_STEPS else 1
        sched = loop.run_schedule(config.replace(
            global_batch_size=RESNET_BATCH // (2 - stage),
            total_steps=RAMP_STAGE_STEPS * (stage + 1)))
        want.append(sched(updates))
        updates += skip == 0.0
    lrs = [x["lr"] for x in metrics]
    stages = summary.get("batch_ramp", {}).get("stages", [])
    log(f"# resnet50 large-batch train ({' '.join(RAMP_FLAGS)}, ramp): CLI "
        f"{cli_s:.2f} s, launches {launches}, expected {expected} (36 x 6 "
        f"for #8-#10, 13 x 6 for #11-#13; the eval forwards launch none), "
        f"losses {losses}, lrs {lrs} (want {want}), loss-scale skips "
        f"{skips}, evals {evals}, peak memory {peak_gb:.2f} GB, stages "
        f"{json.dumps(stages)}, summary {json.dumps(summary)}")
    if launches != expected:
        failures.append(f"large-batch path launches {launches}, expected "
                        f"{expected}")
    if len(losses) != steps_total or not all(np.isfinite(x) for x in losses):
        failures.append(f"large-batch losses {losses}: need {steps_total} "
                        f"finite")
    if sum(skips) > 1:
        failures.append(f"large-batch path skipped {sum(skips)} steps for "
                        f"loss-scale overflow; at most one allowed")
    if len(lrs) != len(want) or any(
            abs(a - b) > 1e-12 + 1e-9 * abs(b) for a, b in zip(lrs, want)):
        failures.append(f"large-batch lrs {lrs}, want {want}")
    if len(stages) != 2 or not all(st.get("examples_per_sec")
                                   for st in stages):
        failures.append(f"large-batch summary without two timed stages: "
                        f"{summary}")
    profile = cli_step_profile(
        ["--model", "resnet50", "--batch-size", str(RESNET_BATCH),
         "--synthetic", "--steps", str(RESNET_STEPS), "--seed", str(SEED),
         *RAMP_FLAGS],
        f"resnet50 train step (bf16, {' '.join(RAMP_FLAGS)}, batch "
        f"{RESNET_BATCH})", ("fused_block", FLBN_KERNELS + FCBN_KERNELS))
    return {"summary": summary, "stages": stages, "peak_memory_gb": peak_gb,
            "profile": profile, "launches": launches}


def phase_scaled_step(failures) -> None:
    """Phase 20: one f32 step of ResNet-50 at batch 32 with loss scale 2^15
    and without, on the same seeded weights and batch, with ``fused_bn``
    (#4-#7) and with ``fused_block`` + ``fused_conv3`` (#8-#13). After
    unscaling, every gradient and running buffer must equal the unscaled
    step's bit for bit, or differ by at most SCALED_STEP_TOL of its largest
    |ref| (each such tensor printed). cuDNN runs its deterministic
    algorithms here, so that both steps convolve alike."""
    import torch

    from distributeddeeplearning_tpu_torch import config as cfglib
    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticImages)
    from distributeddeeplearning_tpu_torch.train import loop, steps

    batch = SyntheticImages(FUSED_BATCH, RESNET_IMAGE, RESNET_CLASSES,
                            SEED + 9, "cuda").batch(0)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, kw in (("fused_bn", {"fused_bn": True}),
                          ("fused_block+fused_conv3",
                           {"fused_block": True, "fused_conv3": True})):
            runs = []
            for scale in (2.0 ** 15, 0.0):
                config = cfglib.TrainConfig(
                    model="resnet50", global_batch_size=FUSED_BATCH,
                    total_steps=2, seed=SEED + 10, dtype="float32",
                    precision=cfglib.PrecisionPolicy(
                        compute_dtype="float32", reduce_dtype="float32",
                        loss_scale=scale), **kw)
                state, sched = loop.build_state(config, torch.device("cuda"))
                metrics = steps.make_train_step(config, sched)(state, batch)
                runs.append(({f"grad {n}": p.grad.clone() for n, p in
                              state.model.named_parameters()}
                             | {f"buffer {n}": b.clone() for n, b in
                                state.model.named_buffers()},
                             float(metrics["loss"]),
                             float(metrics.get("loss_scale_skip", 0.0))))
                del state
                torch.cuda.empty_cache()
            (scaled, loss_s, skip), (plain, loss_p, _) = runs
            differ = {}
            for name, ref in plain.items():
                if not torch.equal(scaled[name], ref):
                    differ[name] = ((scaled[name] - ref).abs().max().item()
                                    / max(ref.abs().max().item(), 1e-30))
            worst = max(differ.values(), default=0.0)
            log(f"# resnet50 f32 step, {label}, loss scale 2^15 vs none "
                f"(batch {FUSED_BATCH}): losses {loss_s!r} / {loss_p!r}, "
                f"skip {skip}, {len(plain) - len(differ)} of {len(plain)} "
                f"tensors bit for bit; differing (share of largest |ref|): "
                f"{json.dumps(differ)}")
            if skip or loss_s != loss_p or worst > SCALED_STEP_TOL:
                failures.append(f"{label} scaled step: skip {skip}, losses "
                                f"{loss_s} / {loss_p}, tensors beyond "
                                f"{SCALED_STEP_TOL}: {differ}")
    finally:
        torch.backends.cudnn.deterministic = deterministic


def run_process(cmd, timeout: float) -> subprocess.CompletedProcess:
    """``cmd`` in a process group of its own, from the checkout's root; on
    a timeout every process of the group is killed before this raises."""
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def resnet50_bucket_plan():
    """The bucket plan of ResNet-50's gradients at the default 4 MB, from
    the parameters' names and shapes alone (built on the meta device)."""
    import torch

    from distributeddeeplearning_tpu_torch.models import model_spec
    from distributeddeeplearning_tpu_torch.parallel import collectives

    with torch.device("meta"):
        model = model_spec("resnet50").build(dtype=torch.bfloat16)
    return collectives.plan_buckets(dict(model.named_parameters()))


def phase_dp_train(kernels, failures, scratch: Path) -> dict:
    """Phase 21, the data-parallel path on one card: the training CLI under
    ``torchrun`` in an NCCL group of one, ResNet-50 ``--fused-block
    --fused-conv3 --sync-bn`` at batch 512. The worker's summary holds its
    kernel launches and peak memory, its profile file the
    ``allreduce/bucketNN`` ranges of steps 1-2."""
    from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as fcbn
    from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as flbn

    profile_dir = scratch / "dp_profile"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m",
           "distributeddeeplearning_tpu_torch.train", *DP_ARGV,
           "--profile-dir", str(profile_dir)]
    t0 = time.perf_counter()
    done = run_process(cmd, DP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = []
    for line in done.stdout.splitlines():
        with contextlib.suppress(ValueError):
            lines.append(json.loads(line))
    metrics, _, summary = split_lines(lines) if lines else ([], [], {})
    losses = [x["loss"] for x in metrics]
    launches = summary.get("kernel_launches", {})
    per_step = {flbn: RESNET_LINEAR_LAYERS, fcbn: RESNET_CONV3_LAYERS}
    expected = {k["name"]: per_step.get(k["module"], 0) * RESNET_STEPS
                for k in kernels}
    plan = resnet50_bucket_plan()
    want = {f"allreduce/bucket{b:02d}" for b in range(len(plan.buckets))}
    steps_profiled = DP_PROFILED[1] - DP_PROFILED[0]
    ranges, device = {}, {}
    profile_file = profile_dir / "profile_rank0.json"
    if profile_file.exists():
        profile = json.loads(profile_file.read_text())
        ranges, device = profile["ranges"], profile["kernels"]
    buckets = {k: v for k, v in ranges.items()
               if k.startswith("allreduce/bucket")}
    nccl = {k: v for k, v in device.items() if "nccl" in k.lower()}

    def a_step(entries, key="device_ms"):
        return sum(v[key] for v in entries.values()) / steps_profiled

    record = {"wall_s": wall_s, "rc": done.returncode, "launches": launches,
              "losses": losses, "plan": plan.describe(),
              "buckets": len(buckets),
              "bucket_device_ms_a_step": a_step(buckets),
              "bucket_host_ms_a_step": a_step(buckets, "cpu_ms"),
              "busy_ms_a_step": a_step(device),
              "nccl_kernel_ms_a_step": a_step(nccl),
              "nccl_kernels_a_step": a_step(nccl, "count"),
              "bucket_counts": {k: v["count"] for k, v in buckets.items()},
              "peak_memory_gb": summary.get("peak_memory_gb"),
              "images_per_sec": summary.get("examples_per_sec"),
              "data_parallel": summary.get("data_parallel")}
    log("# resnet50 --fused-block --fused-conv3 --sync-bn under torchrun "
        "(NCCL, world 1): " + json.dumps(record))
    if done.returncode != 0:
        failures.append(f"torchrun DP run exited {done.returncode}: "
                        f"{done.stderr[-3000:]}")
        return record
    if launches != expected:
        failures.append(f"DP path launches {launches}, expected {expected}")
    if (len(losses) != RESNET_STEPS
            or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - np.log(RESNET_CLASSES))
            > RESNET_FIRST_LOSS_TOL):
        failures.append(f"DP losses {losses}: need {RESNET_STEPS} finite, "
                        f"the first within {RESNET_FIRST_LOSS_TOL} of ln "
                        f"{RESNET_CLASSES}")
    dp = summary.get("data_parallel") or {}
    if dp.get("world") != 1 or dp.get("backend") != "nccl":
        failures.append(f"DP run not in an NCCL group of one: {dp}")
    if set(buckets) != want or any(
            v["count"] != steps_profiled for v in buckets.values()):
        failures.append(f"DP profile buckets {record['bucket_counts']}, "
                        f"want each of {sorted(want)} {steps_profiled} "
                        f"times")
    if not summary.get("examples_per_sec"):
        failures.append(f"DP summary without images/s: {summary}")
    return record


def phase_dp_bitwise(failures, scratch: Path) -> None:
    """Phase 21's second part: one f32 step of ResNet-50 ``fused_block`` +
    ``fused_conv3`` at batch 32 through the data-parallel step with sync BN
    (an NCCL group of one, in this process) against the one-card step,
    from the same weights and batch: loss, gradients, running buffers and
    updated parameters bit for bit."""
    import torch
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch import config as cfglib
    from distributeddeeplearning_tpu_torch.data.synthetic import (
        SyntheticImages)
    from distributeddeeplearning_tpu_torch.parallel.process_group import (
        DataParallel)
    from distributeddeeplearning_tpu_torch.train import loop, steps

    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{scratch / 'nccl_rendezvous'}", rank=0,
        world_size=1)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = SyntheticImages(FUSED_BATCH, RESNET_IMAGE, RESNET_CLASSES,
                                SEED + 11, "cuda").batch(0)
        base = cfglib.TrainConfig(
            model="resnet50", global_batch_size=FUSED_BATCH, total_steps=2,
            seed=SEED + 12, dtype="float32", fused_block=True,
            fused_conv3=True)
        runs = []
        for config, dp in ((base, None),
                           (base.replace(sync_bn=True), DataParallel(0, 1))):
            state, sched = loop.build_state(config, torch.device("cuda"))
            if runs:
                state.model.load_state_dict(runs[0][1])
            weights = {k: v.clone() for k, v in
                       state.model.state_dict().items()}
            metrics = steps.make_train_step(config, sched, dp)(state, batch)
            runs.append((float(metrics["loss"]), weights,
                         {f"grad {n}": p.grad.clone() for n, p in
                          state.model.named_parameters()}
                         | {f"after {k}": v.clone() for k, v in
                            state.model.state_dict().items()}))
            del state
            torch.cuda.empty_cache()
        (loss_1, _, one), (loss_dp, _, dp_run) = runs
        differ = [k for k in one if not torch.equal(one[k], dp_run[k])]
        log(f"# resnet50 f32 step, fused_block+fused_conv3, DP with sync BN "
            f"(NCCL, world 1) vs one card (batch {FUSED_BATCH}): losses "
            f"{loss_dp!r} / {loss_1!r}, {len(one) - len(differ)} of "
            f"{len(one)} tensors bit for bit; differing: {differ}")
        if loss_dp != loss_1 or differ:
            failures.append(f"DP world-1 step differs from the one-card "
                            f"step: losses {loss_dp} / {loss_1}, tensors "
                            f"{differ}")
    finally:
        torch.backends.cudnn.deterministic = deterministic
        dist.destroy_process_group()


def phase_lars_32k(kernels, failures) -> dict:
    """Phase 22, the real 32k LARS update on one card: the
    ``resnet50_lars_32k`` preset at ``--dp 1 --accum 64 --fused-block
    --fused-conv3``, 2 updates of 64 microbatches of 512. First one update
    at batch 512 (``--accum 1``) for its peak memory; then the 32k run:
    #8-#10 36 x 64 and #11-#13 13 x 64 launches an update, no other
    kernel; losses finite; each lr the schedule's at the update count; the
    peak memory less the images of its global batch within
    LARS_MEMORY_SLACK of the batch-512 update's less its images."""
    import torch

    from distributeddeeplearning_tpu_torch.ops import fused_conv_bn as fcbn
    from distributeddeeplearning_tpu_torch.ops import fused_linear_bn as flbn
    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop

    def image_gb(batch: int) -> float:   # bf16 NHWC images and int64 labels
        return batch * (RESNET_IMAGE * RESNET_IMAGE * 3 * 2 + 8) / 1e9

    small = [*LARS_FLAGS, "--accum", "1", "--batch-size", str(RESNET_BATCH),
             "--steps", "1"]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_train_cli(small)
    torch.cuda.synchronize()
    peak_512 = torch.cuda.max_memory_allocated() / 1e9
    argv = [*LARS_FLAGS, "--accum", str(LARS_ACCUM), "--steps",
            str(LARS_UPDATES)]
    config = train_cli.build_config(train_cli.parse_args(argv))
    per_update = {flbn: RESNET_LINEAR_LAYERS * LARS_ACCUM,
                  fcbn: RESNET_CONV3_LAYERS * LARS_ACCUM}
    expected = {k["name"]: per_update.get(k["module"], 0) * LARS_UPDATES
                for k in kernels}
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(kernels)
    t0 = time.perf_counter()
    lines = run_train_cli(argv)
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    launches = read_counts(kernels)
    peak = torch.cuda.max_memory_allocated() / 1e9
    metrics, _, summary = split_lines(lines)
    losses = [x["loss"] for x in metrics]
    lrs = [x["lr"] for x in metrics]
    sched = loop.run_schedule(config)
    want = [sched(k) for k in range(LARS_UPDATES)]
    batch = config.global_batch_size
    record = {"global_batch": batch, "accum": LARS_ACCUM,
              "microbatch": batch // LARS_ACCUM, "cli_s": cli_s,
              "launches": launches, "losses": losses, "lrs": lrs,
              "want_lrs": want, "peak_memory_gb": peak,
              "peak_memory_gb_batch512_update": peak_512,
              "images_gb": image_gb(batch),
              "images_per_sec": summary.get("examples_per_sec"),
              "update_s": (batch / summary["examples_per_sec"]
                           if summary.get("examples_per_sec") else None)}
    log("# resnet50_lars_32k --dp 1 --accum 64 --fused-block --fused-conv3: "
        + json.dumps(record))
    if launches != expected:
        failures.append(f"32k LARS launches {launches}, expected {expected}")
    if len(losses) != LARS_UPDATES or not all(np.isfinite(x)
                                              for x in losses):
        failures.append(f"32k LARS losses {losses}: need {LARS_UPDATES} "
                        f"finite")
    if len(lrs) != len(want) or any(
            abs(a - b) > 1e-12 + 1e-9 * abs(b) for a, b in zip(lrs, want)):
        failures.append(f"32k LARS lrs {lrs}, want {want}")
    if peak - image_gb(batch) > (1 + LARS_MEMORY_SLACK) * (
            peak_512 - image_gb(RESNET_BATCH)):
        failures.append(f"32k LARS peak {peak:.2f} GB less its images "
                        f"{image_gb(batch):.2f} GB is beyond a batch-512 "
                        f"update's {peak_512:.2f} GB less its images")
    if not summary.get("examples_per_sec"):
        failures.append(f"32k LARS summary without images/s: {summary}")
    return record


# Token shards (phase 24): two shards of SHARD_ROWS rows each, 96 of which
# the 6 steps read; the image stream's batches (512 x 224 x 224 x 3 f32).
SHARD_ROWS = 64
STREAM_BATCHES = 8


class _GptVocab:
    """What the loop's source reads of a causal LM: its vocabulary."""

    class cfg:
        vocab_size = VOCAB


def phase_token_shards(kernels, failures, scratch: Path,
                       synthetic: dict) -> dict:
    """Phase 24, real data on the card: GPT-2 small's training path on
    token shards written here, against phase 8's synthetic run; then the
    host-to-card stream's token batches against the host stream's, and the
    stream's rate and device memory at ResNet-50's image batch."""
    import torch

    from distributeddeeplearning_tpu_torch.data import imagenet, tokens
    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop

    shards = scratch / "token_shards"
    shards.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED)
    for k, dtype in enumerate((np.uint16, np.int32)):
        np.save(shards / f"train-{k:05d}.npy",
                rng.integers(1, VOCAB, (SHARD_ROWS, TRAIN_SEQ)).astype(dtype))
    argv = [a for a in TRAIN_ARGV if a != "--synthetic"] + [
        "--data-dir", str(shards)]
    run = run_path("gpt2_small on token shards", kernels, argv, failures,
                   steps=TRAIN_STEPS, per_step=12,
                   first=float(np.log(VOCAB)), first_tol=FIRST_LOSS_TOL,
                   rate="tokens_per_sec")
    summary = run["summary"]
    pipeline = summary.get("input_pipeline", {})
    record = {"input_pipeline": pipeline,
              "tokens_per_sec": summary.get("tokens_per_sec"),
              "synthetic_tokens_per_sec":
                  synthetic["summary"].get("tokens_per_sec"),
              "peak_memory_gb": summary.get("peak_memory_gb")}
    if (pipeline.get("loader") != "tokens"
            or not any("loader=tokens" in x for x in run["log"])):
        failures.append(f"token-shard run did not resolve loader=tokens: "
                        f"{run['log']}, {pipeline}")

    # The card's token batches against the host stream's, bit for bit.
    config = train_cli.build_config(train_cli.parse_args(argv))
    source = loop.make_source(config, _GptVocab(), "cuda")
    host = tokens._batch_stream(config, train=True, start_step=0,
                                objective="causal")
    mismatched = 0
    for step in range(TRAIN_STEPS):
        want = next(host)
        got = source.batch(step)
        mismatched += int(not (
            got["input_ids"].dtype == torch.int64
            and got["input_ids"].device.type == "cuda"
            and torch.equal(got["input_ids"].cpu(),
                            torch.from_numpy(want["input_ids"]).long())
            and torch.equal(got["attention_mask"].cpu(),
                            torch.from_numpy(want["attention_mask"]))))
    source.close()
    record["card_batches_equal_host"] = TRAIN_STEPS - mismatched
    if mismatched:
        failures.append(f"{mismatched} of {TRAIN_STEPS} token batches on "
                        f"the card differ from the host stream's")

    # The stream alone at ResNet-50's batch: numpy f32 images through
    # pinned memory, the side stream's copy and the cast to bf16.
    images = np.random.default_rng(SEED).standard_normal(
        (RESNET_BATCH, RESNET_IMAGE, RESNET_IMAGE, 3), np.float32)
    labels = np.arange(RESNET_BATCH, dtype=np.int32) % RESNET_CLASSES

    def host_batches():
        for _ in range(STREAM_BATCHES + 1):
            yield {"image": images, "label": labels}

    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    stream = imagenet.StreamSource(
        host_batches(), "cuda", depth=2,
        casts={"image": torch.bfloat16, "label": torch.int64})
    first = stream.batch(0)   # the first pin and copy, untimed
    ok = torch.equal(first["image"].float().cpu(),
                     torch.from_numpy(images).bfloat16().float())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for step in range(1, STREAM_BATCHES + 1):
        out = stream.batch(step)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    ok = ok and out["label"].dtype == torch.int64
    stream.close()
    del first, out
    record["image_stream"] = {
        "batch": RESNET_BATCH, "batches": STREAM_BATCHES,
        "images_per_sec": STREAM_BATCHES * RESNET_BATCH / elapsed,
        "host_gb_per_sec": STREAM_BATCHES * images.nbytes / elapsed / 1e9,
        "peak_device_gb_over_base":
            (torch.cuda.max_memory_allocated() - base) / 1e9,
        "exact": bool(ok)}
    if not ok:
        failures.append("the image stream's bf16 batch on the card is not "
                        "the host batch cast to bf16")
    log("# gpt2_small on token shards: " + json.dumps(record))
    return record


# BERT-base masked-LM path (phase 25): the bert_base_mlm preset on one card
# at its 256 x 128, bf16 over f32 masters, AdamW, dropout 0.1.
BERT_BATCH, BERT_SEQ, BERT_STEPS, BERT_VOCAB, BERT_LAYERS = (256, 128, 6,
                                                             30522, 12)
BERT_ARGV = ["--config", "bert_base_mlm", "--dp", "1", "--attn", "flash",
             "--steps", str(BERT_STEPS), "--log-every", "1",
             "--seed", str(SEED)]
# BERT's token shards: two files of this many rows of ids above the
# reserved range, three rows in four ending in a PAD tail of 1 to
# BERT_SEQ - 32 ids.
BERT_SHARD_ROWS = 1024
# ViT-B/16 path (phase 26): 224 px, 16 px patches (S = 197), 1000 classes.
VIT_BATCH, VIT_STEPS, VIT_LAYERS = 256, 6, 12
VIT_ARGV = ["--model", "vit_b16", "--batch-size", str(VIT_BATCH),
            "--synthetic", "--attn", "flash", "--steps", str(VIT_STEPS),
            "--log-every", "1", "--seed", str(SEED)]
# Phase 27: one f32 step at full width through flash and through dense,
# held as phase 9 (STEP_LOSS_TOL, STEP_GRAD_TOL).
MODEL_STEP_BATCH = 8


def phase_bert_train(kernels, failures, scratch: Path) -> dict:
    """Phase 25, BERT-base masked-LM on the card: the ``bert_base_mlm``
    preset with ``--dp 1 --attn flash`` on synthetic batches (the dense
    head over 256 x 128 x 30522 logits), then on token shards written here
    whose PAD tails make the key-padding mask live, with the gather head
    (``--mlm-max-predictions -1``: 19 positions a row); each, #1-#3 12
    launches a step and no other kernel, losses finite and the first
    within 0.5 of ln 30522. Then a device-time profile of one synthetic
    step."""
    shards = scratch / "bert_shards"
    shards.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(SEED + 25)
    pads = 0
    for k in range(2):
        ids = rng.integers(1000, BERT_VOCAB, (BERT_SHARD_ROWS, BERT_SEQ),
                           dtype=np.int32)
        tails = rng.integers(1, BERT_SEQ - 31, BERT_SHARD_ROWS)
        tails[rng.random(BERT_SHARD_ROWS) < 0.25] = 0
        for row, n in enumerate(tails):
            ids[row, BERT_SEQ - n:] = 0       # PAD
        pads += int(tails.sum())
        np.save(shards / f"train-{k:05d}.npy", ids)
    first = float(np.log(BERT_VOCAB))
    synthetic = run_path("bert_base_mlm synthetic (dense head)", kernels,
                         BERT_ARGV + ["--synthetic"], failures,
                         steps=BERT_STEPS, per_step=BERT_LAYERS, first=first,
                         first_tol=FIRST_LOSS_TOL, rate="tokens_per_sec")
    real = run_path("bert_base_mlm token shards (gather head)", kernels,
                    BERT_ARGV + ["--data-dir", str(shards),
                                 "--mlm-max-predictions", "-1"], failures,
                    steps=BERT_STEPS, per_step=BERT_LAYERS, first=first,
                    first_tol=FIRST_LOSS_TOL, rate="tokens_per_sec")
    real["pad_share"] = pads / (2 * BERT_SHARD_ROWS * BERT_SEQ)
    if real["summary"].get("input_pipeline", {}).get("loader") != "tokens":
        failures.append(f"bert token-shard run did not read the shards: "
                        f"{real['summary']}")
    profile = model_step_profile(
        "bert_base_mlm train step (bf16, flash, dropout 0.1, dense head)",
        BERT_ARGV + ["--synthetic"], BERT_SEQ)
    log("# bert_base_mlm: " + json.dumps({
        "tokens_per_sec": {"synthetic": synthetic["summary"].get(
            "tokens_per_sec"), "shards": real["summary"].get(
                "tokens_per_sec")},
        "peak_memory_gb": {"synthetic": synthetic["summary"].get(
            "peak_memory_gb"), "shards": real["summary"].get(
                "peak_memory_gb")},
        "pad_share": real["pad_share"]}))
    return {"synthetic": synthetic, "shards": real, "profile": profile}


def phase_vit_train(kernels, failures) -> dict:
    """Phase 26, ViT-B/16 on the card: ``--model vit_b16 --batch-size 256
    --synthetic --attn flash`` (224 px, S = 197, 1000 classes, bf16) for 6
    steps; #1-#3 12 launches a step and no other kernel, losses finite
    and the first within 0.3 of ln 1000 (the zero classifier gives uniform
    logits). Then a device-time profile of one step."""
    record = run_path("vit_b16 train", kernels, VIT_ARGV, failures,
                      steps=VIT_STEPS, per_step=VIT_LAYERS,
                      first=float(np.log(1000)),
                      first_tol=RESNET_FIRST_LOSS_TOL)
    record["profile"] = model_step_profile(
        "vit_b16 train step (bf16, flash)", VIT_ARGV, 1)
    return record


def phase_model_steps(failures) -> None:
    """Phase 27: one f32 step at full width, flash against dense. BERT-base
    at batch 8 x 128 with padded keys (rows of 128 down to 40 tokens),
    targets at 15% of the real tokens, dropout 0.1 at every site (the hash
    mask drops the same attention probabilities; the residual sites draw
    the same device generators); ViT-B/16 at batch 8 with its classifier
    drawn N(0, 0.02) (the zero one would leave every other gradient 0)."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train.losses import (
        mlm_loss, smoothed_softmax_ce)
    from distributeddeeplearning_tpu_torch.train.steps import dropout_rng

    rng = np.random.default_rng(SEED + 27)
    b = MODEL_STEP_BATCH
    ids = rng.integers(1000, BERT_VOCAB, (b, BERT_SEQ))
    lengths = np.linspace(BERT_SEQ, 40, b).astype(int)
    mask = np.arange(BERT_SEQ)[None, :] < lengths[:, None]
    labels = np.where(mask & (rng.random((b, BERT_SEQ)) < 0.15), ids, -1)
    ids, mask, labels = (torch.as_tensor(x, device="cuda")
                         for x in (ids, mask.astype(np.int32), labels))

    def bert(impl):
        return get_model("bert_base", dtype=torch.float32,
                         attention_impl=impl).train()

    flash_vs_dense_step(
        f"bert_base (batch {b} x {BERT_SEQ}, padded keys, dropout 0.1)",
        bert, lambda m: mlm_loss(m(ids, attention_mask=mask,
                                   rng=dropout_rng(SEED, 0)), labels),
        failures, SEED + 27)
    images = torch.as_tensor(rng.standard_normal(
        (b, RESNET_IMAGE, RESNET_IMAGE, 3), dtype=np.float32), device="cuda")
    classes = torch.as_tensor(rng.integers(0, 1000, b), device="cuda")

    def vit(impl):
        model = get_model("vit_b16", dtype=torch.float32,
                          attention_impl=impl).train()
        torch.nn.init.normal_(model.classifier.weight, std=0.02)
        return model

    flash_vs_dense_step(
        f"vit_b16 (batch {b}, S = 197)", vit,
        lambda m: smoothed_softmax_ce(m(images), classes), failures,
        SEED + 28)


def phase_model_rows(fa, failures) -> dict:
    """The flash kernels at BERT-base's training shape (B=256, S=128, 12
    heads of 64, bf16, full, key padding with rows of 32 to 128 keys, a
    quarter full; dropout 0.1, each kernel timed at rate 0 too, beside the
    library yardstick there) and ViT-B/16's (B=256, S=197, full, every key
    live, rate 0), each against its plain version."""
    import torch

    rng = np.random.default_rng(SEED + 29)
    lengths = rng.integers(32, BERT_SEQ + 1, BERT_BATCH)
    lengths[rng.random(BERT_BATCH) < 0.25] = BERT_SEQ
    bert_args = (fa, BERT_SEQ, BERT_BATCH, 12, 64, "bfloat16", False,
                 [int(n) for n in lengths])
    rows = {"bert": {r["kernel"]: r for r in bwd_case(
        *bert_args, 0.1, SEED + 31, library=True)}}
    for r in bwd_case(*bert_args, 0.0, SEED + 31, library=False, fwd=True):
        rows["bert"][r["kernel"]]["ms_rate0"] = r["ms"]
    torch.cuda.empty_cache()
    rows["vit"] = {r["kernel"]: r for r in bwd_case(
        fa, 197, VIT_BATCH, 12, 64, "bfloat16", False, [197] * VIT_BATCH,
        0.0, SEED + 33, library=True, fwd=True)}
    for shape, by_kernel in rows.items():
        for r in by_kernel.values():
            log(f"# {shape}_shape " + json.dumps(r))
            if not r["ok"]:
                failures.append(f"{r['kernel']} at {shape}'s shape "
                                f"disagrees with its plain version: {r}")
    torch.cuda.empty_cache()
    return rows


# Phase 28: the bert_base_mlm preset's global batch of 256 as --accum 8
# under torchrun: microbatches of 32 x 128, the per-chip shape of the
# preset's --dp 8.
TOKEN_DP_ACCUM, TOKEN_DP_STEPS = 8, 4
TOKEN_DP_ARGV = ["--config", "bert_base_mlm", "--dp", "1", "--accum",
                 str(TOKEN_DP_ACCUM), "--attn", "flash", "--synthetic",
                 "--steps", str(TOKEN_DP_STEPS), "--log-every", "1",
                 "--seed", str(SEED)]
TOKEN_DP_TIMEOUT_S = 420
# The world-1 bitwise step: BERT-base at this batch, --accum 2.
TOKEN_BITWISE_BATCH = 32
# GPT-2 small at --accum 2 against --accum 1 (f32, same global batch).
ACCUM_STEP_BATCH = 8
ACCUM_LOSS_TOL = 1e-5
ACCUM_GRAD_TOL = 1e-4


def phase_token_dp_train(kernels, failures) -> dict:
    """Phase 28's first part: the ``bert_base_mlm`` preset as ``--dp 1
    --accum 8`` under ``torchrun`` (an NCCL group of one); the worker's
    summary holds its kernel launches and peak memory. Then a device-time
    profile of one such step in this process."""
    from distributeddeeplearning_tpu_torch.ops import flash_attention as fa

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "1", "-m",
           "distributeddeeplearning_tpu_torch.train", *TOKEN_DP_ARGV]
    t0 = time.perf_counter()
    done = run_process(cmd, TOKEN_DP_TIMEOUT_S)
    wall_s = time.perf_counter() - t0
    lines = []
    for line in done.stdout.splitlines():
        with contextlib.suppress(ValueError):
            lines.append(json.loads(line))
    metrics, _, summary = split_lines(lines) if lines else ([], [], {})
    losses = [x["loss"] for x in metrics]
    launches = summary.get("kernel_launches", {})
    per_step = BERT_LAYERS * TOKEN_DP_ACCUM
    expected = {k["name"]: per_step * TOKEN_DP_STEPS if k["module"] is fa
                else 0 for k in kernels}
    record = {"wall_s": wall_s, "rc": done.returncode, "launches": launches,
              "losses": losses,
              "tokens_per_sec": summary.get("tokens_per_sec"),
              "peak_memory_gb": summary.get("peak_memory_gb"),
              "data_parallel": summary.get("data_parallel")}
    log("# bert_base_mlm --dp 1 --accum 8 under torchrun (NCCL, world 1, "
        "microbatches of 32 x 128): " + json.dumps(record))
    if done.returncode != 0:
        failures.append(f"torchrun token DP run exited {done.returncode}: "
                        f"{done.stderr[-3000:]}")
        return record
    if launches != expected:
        failures.append(f"token DP path launches {launches}, expected "
                        f"{expected}")
    first = float(np.log(BERT_VOCAB))
    if (len(losses) != TOKEN_DP_STEPS
            or not all(np.isfinite(x) for x in losses)
            or abs(losses[0] - first) > FIRST_LOSS_TOL):
        failures.append(f"token DP losses {losses}: need {TOKEN_DP_STEPS} "
                        f"finite, the first within {FIRST_LOSS_TOL} of ln "
                        f"{BERT_VOCAB}")
    dp = summary.get("data_parallel") or {}
    if dp.get("world") != 1 or dp.get("backend") != "nccl":
        failures.append(f"token DP run not in an NCCL group of one: {dp}")
    if not summary.get("tokens_per_sec"):
        failures.append(f"token DP summary without tokens/s: {summary}")
    record["profile"] = model_step_profile(
        "bert_base_mlm --accum 8 train step (bf16, flash, dropout 0.1, "
        "dense head, 8 x 32 x 128)", TOKEN_DP_ARGV, BERT_SEQ)
    return record


def phase_token_dp_bitwise(failures, scratch: Path) -> None:
    """Phase 28's second part: one BERT-base step at ``--accum 2`` (the
    preset's bf16 policy, flash, dropout 0.1, batch 32 x 128 with PAD
    tails, the dense head) through the data-parallel step (an NCCL group
    of one, in this process) against the one-card step from the same
    weights and batch: loss, gradients and updated parameters bit for bit
    (the count's and the gradients' one-rank sums, the scaling by the
    world of 1 and rank 0's dropout streams are exact)."""
    import torch
    import torch.distributed as dist

    from distributeddeeplearning_tpu_torch.parallel.process_group import (
        DataParallel)
    from distributeddeeplearning_tpu_torch.train import cli as train_cli
    from distributeddeeplearning_tpu_torch.train import loop, steps

    rng = np.random.default_rng(SEED + 28)
    b = TOKEN_BITWISE_BATCH
    lengths = rng.integers(40, BERT_SEQ + 1, b)
    mask = np.arange(BERT_SEQ)[None, :] < lengths[:, None]
    ids = rng.integers(1000, BERT_VOCAB, (b, BERT_SEQ)) * mask
    labels = np.where(mask & (rng.random((b, BERT_SEQ)) < 0.15), ids, -1)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in (
        ("input_ids", ids), ("attention_mask", mask.astype(np.int32)),
        ("labels", labels))}
    config = train_cli.build_config(train_cli.parse_args(
        ["--config", "bert_base_mlm", "--dp", "1", "--accum", "2",
         "--attn", "flash", "--batch-size", str(b), "--steps", "2",
         "--seed", str(SEED + 28)]))
    torch.cuda.set_device(0)
    dist.init_process_group(
        "nccl", init_method=f"file://{scratch / 'nccl_rendezvous_tokens'}",
        rank=0, world_size=1)
    try:
        runs = []
        for dp in (None, DataParallel(0, 1)):
            state, sched = loop.build_state(config, torch.device("cuda"))
            metrics = steps.make_train_step(config, sched, dp)(state, batch)
            runs.append((float(metrics["loss"]),
                         {f"grad {n}": p.grad.clone() for n, p in
                          state.model.named_parameters()}
                         | {f"after {k}": v.clone() for k, v in
                            state.model.state_dict().items()}))
            del state
            torch.cuda.empty_cache()
        (loss_1, one), (loss_dp, dp_run) = runs
        differ = [k for k in one if not torch.equal(one[k], dp_run[k])]
        log(f"# bert_base bf16 step --accum 2, dropout 0.1, DP (NCCL, world "
            f"1) vs one card (batch {b} x {BERT_SEQ}): losses {loss_dp!r} / "
            f"{loss_1!r}, {len(one) - len(differ)} of {len(one)} tensors "
            f"bit for bit; differing: {differ}")
        if loss_dp != loss_1 or differ:
            failures.append(f"token DP world-1 step differs from the "
                            f"one-card step: losses {loss_dp} / {loss_1}, "
                            f"tensors {differ}")
    finally:
        dist.destroy_process_group()


def phase_accum_step(failures) -> None:
    """Phase 28's third part: one f32 step of GPT-2 small (flash, dropout
    0, no clipping) at batch 8 x 1024 with ``--accum 2`` against
    ``--accum 1`` on the same batch and weights: every microbatch counts
    the same tokens, so the two are the same gradient up to summation
    order."""
    import torch

    from distributeddeeplearning_tpu_torch import config as cfglib
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.train import optim, steps
    from distributeddeeplearning_tpu_torch.train.state import TrainState

    ids = torch.as_tensor(np.random.default_rng(SEED + 30).integers(
        1, VOCAB, (ACCUM_STEP_BATCH, TRAIN_SEQ)), device="cuda")
    grads, losses, weights = {}, {}, None
    torch.manual_seed(SEED + 30)
    for accum in (1, 2):
        config = cfglib.TrainConfig(
            model="gpt2_small", global_batch_size=ACCUM_STEP_BATCH,
            dtype="float32", attention_impl="flash", grad_accum_steps=accum)
        model = get_model("gpt2_small", dtype=torch.float32,
                          attention_impl="flash", dropout_rate=0.0).train()
        if weights is None:
            weights = model.state_dict()
        else:
            model.load_state_dict(weights)
        opt, sched = optim.make_optimizer(config.optimizer, model,
                                          ACCUM_STEP_BATCH, 1)
        state = TrainState(step=0, model=model, optimizer=opt)
        metrics = steps.make_train_step(config, sched)(
            state, {"input_ids": ids})
        losses[accum] = float(metrics["loss"])
        grads[accum] = {n: p.grad for n, p in model.named_parameters()}
        del model, state, opt
    worst, worst_name = worst_grad_err(grads[2], grads[1])
    loss_err = abs(losses[2] - losses[1])
    record = {"losses": losses, "loss_err": loss_err, "worst_grad_err": worst,
              "worst_grad": worst_name}
    log(f"# gpt2_small f32 step (batch {ACCUM_STEP_BATCH} x {TRAIN_SEQ}), "
        f"--accum 2 vs --accum 1: " + json.dumps(record))
    if not loss_err <= ACCUM_LOSS_TOL or not worst <= ACCUM_GRAD_TOL:
        failures.append(f"--accum 2 vs --accum 1 step: loss err {loss_err}, "
                        f"gradient err {worst} ({worst_name})")
    del grads
    torch.cuda.empty_cache()


# Serving (phase 29): GPT-2 small uncut in float32 through the engine's
# entry point, 48 requests from the seed: prompts of 32-512 tokens, 8-64 new
# tokens each, arrivals over the first SERVE_ARRIVAL_S seconds (the whole
# run takes a few seconds), half of them behind one 256-token head (16 full
# pages: later ones hit the radix tree; two whose prompt is the head alone
# reuse 255 of its tokens and copy the trailing page on write).
SERVE_CONFIG = {"model": "gpt2_small", "vocab_size": VOCAB,
                "dtype": "float32", "max_slots": 32, "page_size": 16,
                "max_pages_per_slot": 64, "num_pages": 1024,
                "prefill_buckets": [64, 128, 256, 512], "prefix_cache": True,
                "seed": SEED}
SERVE_REQUESTS, SERVE_HEAD, SERVE_ARRIVAL_S = 48, 256, 1.0
# A request's greedy tokens must equal generate(use_cache=True) of it alone;
# they may part only at a step where the reference's top two logits lie
# within this share of its largest |logit| (a tie: f32 sums in another
# order, batch 32 against 1, may pick the other).
SERVE_TIE_TOL = 1e-4
# The preemption run (the shape of the JAX engine's test): TinyLlama-1.1B's
# widths at 2 layers, 16-token pages; "bg" holds 12 pages (64 + 128 tokens)
# of 24, its cap drops to 8, and "rt" (128 + 128 tokens, 16 pages) starves.
PREEMPT_CONFIG = {"model": "tinyllama_1b", "vocab_size": 32000,
                  "dtype": "float32", "max_slots": 2, "page_size": 16,
                  "max_pages_per_slot": 16, "num_pages": 24,
                  "prefill_buckets": [64, 128, 256], "seed": SEED}
# Speculative serving (phase 30): proposals a round, the drafter's depth
# (GPT-2 small's widths), the self-draft's requests and the share of its
# proposals that must be accepted (equal weights; the drafter's paged step
# and the verify's block sum in other orders, so a near-tie may reject);
# the preemption run's proposals a round.
SPEC_K, SPEC_DRAFT_LAYERS = 4, 2
SPEC_SELF_REQUESTS, SPEC_SELF_ACCEPT_MIN = 8, 0.95
PREEMPT_SPEC_K = 3
# Beam search (phase 32): prompts of BEAM_PROMPT_LEN, beams, new tokens;
# two runs may part only where the parting candidates' summed
# log-probabilities lie within BEAM_TIE_TOL.
BEAM_PROMPT_LEN, BEAM_WIDTH, BEAM_NEW = 64, 4, 32
BEAM_TIE_TOL = 1e-4


def serve_traffic(rng) -> list[dict]:
    """The phase's requests: every other one behind the shared head, the
    others of SERVE_HEAD / 8 to 2 SERVE_HEAD tokens."""
    vocab = SERVE_CONFIG["vocab_size"]
    head = rng.integers(0, vocab, SERVE_HEAD).tolist()
    arrivals = np.sort(rng.uniform(0.0, SERVE_ARRIVAL_S, SERVE_REQUESTS))
    requests = []
    for i in range(SERVE_REQUESTS):
        if i % 2:
            plen = int(rng.integers(SERVE_HEAD // 8, 2 * SERVE_HEAD + 1))
            prompt = rng.integers(0, vocab, plen).tolist()
        else:
            tail = (0 if i in (6, 14)
                    else int(rng.integers(1, SERVE_HEAD + 1)))
            prompt = head + rng.integers(0, vocab, tail).tolist()
        requests.append({"prompt": prompt,
                         "max_new_tokens": int(rng.integers(8, 65)),
                         "arrival_s": float(arrivals[i])})
    return requests


def greedy_check(model, prompt, tokens, max_new: int) -> dict:
    """``tokens`` against ``generate(use_cache=True)`` of the prompt alone:
    where they part, the reference's logits at that step (its cached decode
    replayed) must hold a tie within SERVE_TIE_TOL."""
    import torch

    from distributeddeeplearning_tpu_torch.models.generate import generate

    ref = generate(model, [prompt], max_new_tokens=max_new,
                   use_cache=True)[0, len(prompt):].tolist()
    if tokens == ref:
        return {"same": True}
    j = next((i for i, (a, b) in enumerate(zip(tokens, ref)) if a != b),
             min(len(tokens), len(ref)))
    if j >= min(len(tokens), len(ref)):
        return {"same": False, "step": j, "tie": False,
                "why": f"{len(tokens)} tokens, reference {len(ref)}"}
    cache = model.init_cache(1)
    ids = torch.as_tensor([prompt + ref[:j]],
                          device=next(model.parameters()).device)
    with torch.inference_mode():
        logits = model(ids[:, :len(prompt)], cache=cache)[0, -1]
        for t in range(len(prompt), ids.shape[1]):
            logits = model(ids[:, t:t + 1], cache=cache)[0, -1]
    top = torch.topk(logits, 2).values
    gap = float(top[0] - top[1])
    limit = SERVE_TIE_TOL * float(logits.abs().max())
    return {"same": False, "step": j, "gap": gap, "limit": limit,
            "tie": gap <= limit and tokens[j] in torch.topk(
                logits, 2).indices.tolist()}


def phase_serve(kernels, failures, scratch: Path) -> dict:
    """Phase 29: GPT-2 small served through ``python -m
    distributeddeeplearning_tpu_torch.serve``, every request held against
    ``generate(use_cache=True)`` of it alone; the decode step's profile;
    the preemption run on TinyLlama-1.1B's widths at 2 layers."""
    import torch

    from distributeddeeplearning_tpu_torch import generate as gen_cli
    from distributeddeeplearning_tpu_torch.serve import cli as serve_cli
    from distributeddeeplearning_tpu_torch.serve.engine import (
        Engine, ServeConfig)
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_from_flax)

    name = SERVE_CONFIG["model"]
    npz = scratch / "serve_params.npz"
    np.savez(npz, **seeded_flax_params(
        name, SEED, vocab_size=SERVE_CONFIG["vocab_size"]))
    requests = serve_traffic(np.random.default_rng(SEED + 29))
    (scratch / "serve_requests.json").write_text(json.dumps(requests))
    (scratch / "serve_config.json").write_text(json.dumps(SERVE_CONFIG))
    out_path = scratch / "serve_out.json"
    reset_counts(kernels)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main([
            "--serve", str(scratch / "serve_requests.json"),
            "--serve-config", str(scratch / "serve_config.json"),
            "--serve-out", str(out_path), "--params", str(npz)])
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    log(buf.getvalue().strip().splitlines()[-1])
    out = json.loads(out_path.read_text())
    counters = out["counters"]
    record = {key: out[key] for key in (
        "window_s", "tokens_emitted", "tokens_per_s", "ttft_s", "itl_s",
        "peak_memory_gb", "max_pages_in_use", "max_page_occupancy",
        "pool_bytes", "warmup_s", "leak_check_ok")}
    record["counters"] = counters
    record["last_arrival_s"] = requests[-1]["arrival_s"]
    log(f"# serve {name} (f32, {len(requests)} requests, "
        f"{SERVE_CONFIG['max_slots']} slots, {SERVE_CONFIG['num_pages']} "
        f"pages of {SERVE_CONFIG['page_size']}): " + json.dumps(record))
    if rc != 0 or not out["leak_check_ok"]:
        failures.append(f"serve entry point exited {rc}, leak check "
                        f"{out['leak_check_ok']}")
    if any(launches.values()):
        failures.append(f"the serve path launched kernels of the port: "
                        f"{launches}")
    if counters["prefix_hits"] < 1 or counters["cow_copies"] < 1:
        failures.append(f"serve prefix cache: {counters['prefix_hits']} "
                        f"hits, {counters['cow_copies']} copies on write")

    model = gen_cli.load_model(name, str(npz), attn="dense")
    same, ties = 0, []
    for uid, req in enumerate(requests):
        res = out["results"][str(uid)]
        if not res["finished"]:
            failures.append(f"serve request {uid} did not finish: "
                            f"{res['failed']}")
            continue
        check = greedy_check(model, req["prompt"], res["tokens"],
                             req["max_new_tokens"])
        if check["same"]:
            same += 1
        elif check["tie"]:
            ties.append({"uid": uid, **check})
        else:
            failures.append(f"serve request {uid} parts from generate("
                            f"use_cache=True): {check}")
    log(f"# serve {name}: {same}/{len(requests)} requests token for "
        f"token equal to generate(use_cache=True); ties: "
        + json.dumps(ties))
    tied = {t["uid"] for t in ties}
    # Phases 30 and 31 serve the same requests: a request whose tokens
    # equal these (checked equal, not tied) needs no second reference.
    checked = {uid: out["results"][str(uid)]["tokens"]
               for uid in range(len(requests))
               if out["results"][str(uid)]["finished"] and uid not in tied}

    # The decode step at 32 live slots: the first 32 requests admitted
    # into a fresh engine, then one paged decode forward profiled.
    engine = Engine(ServeConfig.from_dict(SERVE_CONFIG), state_dict=(
        params_from_flax(dict(np.load(npz)))))
    for req in requests[:SERVE_CONFIG["max_slots"]]:
        engine.submit(req["prompt"], max_new_tokens=req["max_new_tokens"])
    engine.step()
    live = engine.num_live
    profile = step_profile(f"serve {name} decode step ({live} slots)",
                           engine._run_decode,
                           focus=("gemm", ("gemm", "gemv", "cutlass",
                                           "xmma", "nvjet")))
    record["decode_profile"] = profile
    del engine, model
    torch.cuda.empty_cache()
    record["preemption"] = phase_serve_preemption(failures)
    record["checked_tokens"] = checked
    record["requests"] = requests
    record["params"] = npz
    return record


def phase_serve_preemption(failures, spec_k: int = 0) -> dict:
    """The preemption run: a tenant's page cap tightened mid-run, then a
    starved request; the victim re-queues with its tokens folded in, and
    both must equal generate(use_cache=True) (TinyLlama-1.1B's widths at 2
    layers through the paged branch, the dense prefill path). With
    ``spec_k``, speculatively, a drafter of TinyLlama's widths at 1 layer
    beside it (weights from SEED + 30), re-prefilled on resume."""
    import torch

    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.serve.engine import (
        Engine, ServeConfig)
    from distributeddeeplearning_tpu_torch.serve.scheduler import (
        TenantPolicy)
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_from_flax)

    spec = ({"spec_draft_model": PREEMPT_CONFIG["model"], "spec_k": spec_k}
            if spec_k else {})
    config = ServeConfig.from_dict({**PREEMPT_CONFIG, **spec})
    state = params_from_flax(seeded_flax_params(
        config.model, SEED + 29, num_layers=2, vocab_size=config.vocab_size))
    model = get_model(config.model, dtype=torch.float32, num_layers=2,
                      vocab_size=config.vocab_size,
                      decode_cache_len=config.slot_capacity)
    draft = {}
    if spec_k:
        draft = {"draft_model": get_model(
                     config.model, dtype=torch.float32, num_layers=1,
                     vocab_size=config.vocab_size,
                     decode_cache_len=config.slot_capacity),
                 "draft_state_dict": params_from_flax(seeded_flax_params(
                     config.model, SEED + 30, num_layers=1,
                     vocab_size=config.vocab_size))}
    engine = Engine(config, model=model, state_dict=state, **draft)
    rng = np.random.default_rng(SEED + 31)
    bg_prompt = rng.integers(0, config.vocab_size, 64).tolist()
    rt_prompt = rng.integers(0, config.vocab_size, 128).tolist()
    bg = engine.submit(bg_prompt, max_new_tokens=128, tenant="bg")
    engine.step()
    engine.step()
    engine.scheduler.policies["bg"] = TenantPolicy("bg", max_pages=8)
    rt = engine.submit(rt_prompt, max_new_tokens=128, tenant="rt")
    engine.step()
    preempted = engine.preemptions
    del engine.scheduler.policies["bg"]
    engine.run_until_idle()
    engine.shutdown()
    record = {"preemptions": engine.preemptions, "steps": engine.steps,
              "bg_preemptions": bg.preemptions}
    if spec_k:
        record.update(spec_rounds=engine.spec_rounds,
                      spec_proposed=engine.spec_proposed,
                      spec_accepted=engine.spec_accepted)
    for name, req in (("bg", bg), ("rt", rt)):
        record[name] = greedy_check(engine.model, req.prompt, req.tokens,
                                    req.max_new_tokens)
        if not (record[name]["same"] or record[name]["tie"]):
            failures.append(f"preemption run{' (spec)' if spec_k else ''}"
                            f": {name} parts from generate(use_cache=True):"
                            f" {record[name]}")
    label = (f", drafter at 1 layer, spec_k={spec_k}" if spec_k else "")
    log(f"# serve preemption run ({config.model} widths x 2 layers, f32"
        f"{label}): " + json.dumps(record))
    if preempted < 1 or bg.preemptions < 1:
        failures.append(f"preemption run: {preempted} preemptions")
    if spec_k and engine.spec_rounds < 1:
        failures.append("preemption run: no speculative round")
    del engine, model, draft
    torch.cuda.empty_cache()
    return record


def check_served(failures, label, model, requests, results, checked) -> dict:
    """Every request finished and equal to ``generate(use_cache=True)`` of
    it alone but at a tie; tokens equal to ``checked`` (an earlier run's,
    checked equal) need no second reference."""
    same, ties = 0, []
    for uid, req in enumerate(requests):
        res = results[str(uid)]
        if not res["finished"]:
            failures.append(f"{label} request {uid} did not finish: "
                            f"{res['failed']}")
            continue
        if checked.get(uid) == res["tokens"]:
            same += 1
            continue
        check = greedy_check(model, req["prompt"], res["tokens"],
                             req["max_new_tokens"])
        if check["same"]:
            same += 1
        elif check["tie"]:
            ties.append({"uid": uid, **check})
        else:
            failures.append(f"{label} request {uid} parts from generate("
                            f"use_cache=True): {check}")
    log(f"# {label}: {same}/{len(requests)} requests token for token equal "
        f"to generate(use_cache=True); ties: " + json.dumps(ties))
    return {"same": same, "ties": ties}


def serve_figures(out: dict) -> dict:
    return {key: out[key] for key in (
        "window_s", "tokens_emitted", "tokens_per_s", "ttft_s", "itl_s",
        "peak_memory_gb", "max_pages_in_use", "warmup_s", "leak_check_ok",
        "counters")}


def phase_serve_spec(kernels, failures, scratch: Path, served: dict) -> dict:
    """Phase 30: phase 29's requests and config served speculatively
    (spec_k = SPEC_K) with a drafter of GPT-2 small's widths at 2 layers
    (1024 positions, weights from SEED + 1), passed to the engine; the
    self-draft through the entry point (the registry's target and drafter
    from the config's seed: equal weights); the preemption run with a
    drafter."""
    import torch

    from distributeddeeplearning_tpu_torch import generate as gen_cli
    from distributeddeeplearning_tpu_torch.models import get_model, model_spec
    from distributeddeeplearning_tpu_torch.serve import cli as serve_cli
    from distributeddeeplearning_tpu_torch.serve.engine import ServeConfig
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_from_flax)

    name, requests = SERVE_CONFIG["model"], served["requests"]
    config = ServeConfig.from_dict({**SERVE_CONFIG, "spec_draft_model": name,
                                    "spec_k": SPEC_K})
    draft = get_model(name, dtype=torch.float32, num_layers=SPEC_DRAFT_LAYERS,
                      vocab_size=VOCAB)
    dstate = params_from_flax(seeded_flax_params(
        name, SEED + 1, num_layers=SPEC_DRAFT_LAYERS, vocab_size=VOCAB))
    state = params_from_flax(dict(np.load(served["params"])))
    reset_counts(kernels)
    out, _ = serve_cli.serve(requests, config, state_dict=state,
                             draft_model=draft, draft_state_dict=dstate)
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    record = serve_figures(out)
    c = out["counters"]
    record["acceptance"] = (c["spec_accepted"] / c["spec_proposed"]
                            if c["spec_proposed"] else None)
    log(f"# serve spec {name} (f32, drafter {SPEC_DRAFT_LAYERS} layers, "
        f"spec_k={SPEC_K}, {len(requests)} requests; untraced phase 29: "
        f"{served['tokens_per_s']} tokens/s): " + json.dumps(record))
    if not out["leak_check_ok"]:
        failures.append("serve spec: leak check failed")
    if any(launches.values()):
        failures.append(f"the serve spec path launched kernels of the port:"
                        f" {launches}")
    if c["spec_rounds"] < 1:
        failures.append("serve spec: no speculative round")
    model = gen_cli.load_model(name, str(served["params"]), attn="dense")
    record["check"] = check_served(failures, f"serve spec {name}", model,
                                   requests, out["results"],
                                   served["checked_tokens"])
    del model, draft, state, dstate
    torch.cuda.empty_cache()

    # The self-draft through the entry point, without --params.
    few = requests[:SPEC_SELF_REQUESTS]
    (scratch / "self_requests.json").write_text(json.dumps(few))
    (scratch / "self_config.json").write_text(json.dumps(
        {**SERVE_CONFIG, "spec_draft_model": name, "spec_k": SPEC_K}))
    out_path = scratch / "self_out.json"
    reset_counts(kernels)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main([
            "--serve", str(scratch / "self_requests.json"),
            "--serve-config", str(scratch / "self_config.json"),
            "--serve-out", str(out_path)])
    launches = read_counts(kernels)
    out = json.loads(out_path.read_text())
    c = out["counters"]
    ratio = (c["spec_accepted"] / c["spec_proposed"]
             if c["spec_proposed"] else 0.0)
    self_record = {**serve_figures(out), "acceptance": ratio}
    log(f"# serve self-draft {name} through the entry point ({len(few)} "
        f"requests, registry weights from seed {SEED}): "
        + json.dumps(self_record))
    if rc != 0 or any(launches.values()):
        failures.append(f"serve self-draft: exit {rc}, launches {launches}")
    if ratio < SPEC_SELF_ACCEPT_MIN:
        failures.append(f"serve self-draft: accepted/proposed {ratio} < "
                        f"{SPEC_SELF_ACCEPT_MIN}")
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(SEED)
        model = model_spec(name).build(vocab_size=VOCAB,
                                       dtype=torch.float32)
    model = model.cuda().eval()
    self_record["check"] = check_served(
        failures, f"serve self-draft {name}", model, few, out["results"], {})
    record["self_draft"] = self_record
    del model
    torch.cuda.empty_cache()
    record["preemption"] = phase_serve_preemption(failures,
                                                  spec_k=PREEMPT_SPEC_K)
    return record


def phase_serve_traced(kernels, failures, scratch: Path,
                       served: dict) -> dict:
    """Phase 31: phase 29's run again with ``--serve-trace-dir``: the merged
    trace loads, every ``serve:*`` name in it is registered, every
    finished request's attribution sums to its latency and TTFT within 1
    ms; the p50/p99 of each TTFT component, and tokens/s beside phase
    29's untraced rate (tracing's cost, not gated); every request equal to
    ``generate(use_cache=True)`` but at a tie, as in phase 29."""
    import torch

    from distributeddeeplearning_tpu_torch import generate as gen_cli
    from distributeddeeplearning_tpu_torch.observability import telemetry
    from distributeddeeplearning_tpu_torch.serve import cli as serve_cli
    from distributeddeeplearning_tpu_torch.serve import tracing

    requests = served["requests"]
    (scratch / "traced_requests.json").write_text(json.dumps(requests))
    (scratch / "traced_config.json").write_text(json.dumps(SERVE_CONFIG))
    out_path, trace_dir = scratch / "traced_out.json", scratch / "trace"
    reset_counts(kernels)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = serve_cli.main([
            "--serve", str(scratch / "traced_requests.json"),
            "--serve-config", str(scratch / "traced_config.json"),
            "--serve-out", str(out_path), "--params", str(served["params"]),
            "--serve-trace-dir", str(trace_dir)])
    torch.cuda.synchronize()
    launches = read_counts(kernels)
    out = json.loads(out_path.read_text())
    events, error = telemetry.load_events_tolerant(out["merged_trace"])
    names = {e.get("name", "") for e in events}
    unregistered = sorted(n for n in names if n.startswith("serve:")
                          and n not in tracing.REGISTERED_PHASES)
    atts = [e["args"] for e in events if e.get("name") == "serve:attribution"
            and e["args"].get("status") == "ok"]
    worst = max((max(abs(a["sum_err_s"]), abs(a.get("ttft_sum_err_s", 0.0)))
                 for a in atts), default=None)
    finished = sum(r["finished"] for r in out["results"].values())
    same = sum(out["results"][str(uid)]["tokens"] == tokens
               for uid, tokens in served["checked_tokens"].items())
    model = gen_cli.load_model(SERVE_CONFIG["model"], str(served["params"]),
                               attn="dense")
    check = check_served(failures, "serve traced", model, requests,
                         out["results"], served["checked_tokens"])
    del model
    torch.cuda.empty_cache()
    record = {**serve_figures(out), "untraced_tokens_per_s":
              served["tokens_per_s"],
              "traced_over_untraced": (out["tokens_per_s"]
                                       / served["tokens_per_s"]),
              "events": len(events), "attributions": len(atts),
              "worst_sum_err_s": worst,
              "ttft_components_s": out["ttft_components_s"],
              "latency_components_s": out["latency_components_s"],
              "tokens_equal_to_phase_29": same, "check": check}
    log(f"# serve traced {SERVE_CONFIG['model']} (--serve-trace-dir, "
        f"{len(requests)} requests): " + json.dumps(record))
    if rc != 0 or not out["leak_check_ok"] or any(launches.values()):
        failures.append(f"serve traced: exit {rc}, leak check "
                        f"{out['leak_check_ok']}, launches {launches}")
    if error is not None or unregistered:
        failures.append(f"serve traced: merged trace {error}, unregistered "
                        f"names {unregistered}")
    if len(atts) != finished or worst is None or worst >= 1e-3:
        failures.append(f"serve traced: {len(atts)} attributions for "
                        f"{finished} finished requests, worst sum error "
                        f"{worst}")
    return record



# serve_ab: runs of each kind in one process, in turns.
SERVE_AB_REPEATS = 3
SERVE_AB_KEYS = ("tokens_per_s", "window_s", "ttft_s", "itl_s")


def serve_ab(first: str, second: str) -> int:
    """Phase 29's untraced serve run with the port of checkout ``first``
    and of ``second``, each in a process of its own, in turns (first,
    second, second, first); a checkout that has them also serves the same
    requests traced (phase 31) and speculatively (phase 30's drafter), in
    turns with its untraced runs, so that each ratio is read within one
    process."""
    for root in (first, second, second, first):
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--serve-run",
             root], capture_output=True, text=True, timeout=900)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode or not lines:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            return 1
        log("# serve_ab " + json.dumps({"checkout": root,
                                         **json.loads(lines[-1])}))
    return 0


def serve_run(root: str) -> int:
    """``serve_ab``'s child: phase 29's requests served through the entry
    point SERVE_AB_REPEATS times with the port of checkout ``root``, each
    untraced run followed, where the checkout has them, by a traced one
    (``--serve-trace-dir``) and a speculative one (phase 30's drafter);
    its record as the last line."""
    import tempfile

    import torch

    sys.path.insert(0, str(Path(root).resolve()))
    if not torch.cuda.is_available():
        return 1
    from distributeddeeplearning_tpu_torch.models import get_model
    from distributeddeeplearning_tpu_torch.serve import cli as serve_cli
    from distributeddeeplearning_tpu_torch.serve.engine import ServeConfig
    from distributeddeeplearning_tpu_torch.utils.weights import (
        params_from_flax)

    later = hasattr(ServeConfig, "spec_enabled")
    name = SERVE_CONFIG["model"]
    scratch = Path(tempfile.mkdtemp(prefix="serve_ab_"))
    try:
        flax = seeded_flax_params(name, SEED,
                                  vocab_size=SERVE_CONFIG["vocab_size"])
        np.savez(scratch / "params.npz", **flax)
        state = params_from_flax(flax)
        requests = serve_traffic(np.random.default_rng(SEED + 29))
        (scratch / "requests.json").write_text(json.dumps(requests))
        (scratch / "config.json").write_text(json.dumps(SERVE_CONFIG))
        argv = ["--serve", str(scratch / "requests.json"),
                "--serve-config", str(scratch / "config.json"),
                "--serve-out", str(scratch / "out.json"),
                "--params", str(scratch / "params.npz")]
        kinds = ("untraced", "traced", "spec") if later else ("untraced",)
        runs = {kind: [] for kind in kinds}
        for r in range(SERVE_AB_REPEATS):
            for kind in kinds:
                if kind == "spec":
                    draft = get_model(name, dtype=torch.float32,
                                      num_layers=SPEC_DRAFT_LAYERS,
                                      vocab_size=VOCAB)
                    dstate = params_from_flax(seeded_flax_params(
                        name, SEED + 1, num_layers=SPEC_DRAFT_LAYERS,
                        vocab_size=VOCAB))
                    out, _ = serve_cli.serve(
                        requests, ServeConfig.from_dict(
                            {**SERVE_CONFIG, "spec_draft_model": name,
                             "spec_k": SPEC_K}),
                        state_dict=state, draft_model=draft,
                        draft_state_dict=dstate)
                    del draft, dstate
                else:
                    extra = (["--serve-trace-dir", str(scratch / f"t{r}")]
                             if kind == "traced" else [])
                    with contextlib.redirect_stdout(io.StringIO()):
                        rc = serve_cli.main(argv + extra)
                    out = json.loads((scratch / "out.json").read_text())
                    if rc != 0:
                        return 1
                torch.cuda.synchronize()
                runs[kind].append({k: out[k] for k in SERVE_AB_KEYS})
                torch.cuda.empty_cache()
        record = {"runs": runs, "median_tokens_per_s": {
            kind: float(np.median([x["tokens_per_s"] for x in v]))
            for kind, v in runs.items()}}
        log(json.dumps(record))
        return 0
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

def beam_tie(model, prompt, a, b) -> dict:
    """Where beam outputs ``a`` and ``b`` of one prompt part: each one's
    summed log-probability through the parting step (its candidate score
    there) from one dense f32 forward; a tie when they lie within
    BEAM_TIE_TOL."""
    import torch

    j = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
    scores = []
    with torch.inference_mode():
        for seq in (a, b):
            ids = torch.as_tensor([seq[:j + 1]], device="cuda")
            logp = torch.log_softmax(model(ids)[0].double(), dim=-1)
            pos = torch.arange(len(prompt) - 1, j, device="cuda")
            scores.append(float(logp[pos, ids[0, pos + 1]].sum()))
    gap = abs(scores[0] - scores[1])
    return {"step": j - len(prompt), "scores": scores, "gap": gap,
            "tie": gap <= BEAM_TIE_TOL}


def phase_beam_spec(kernels, failures, scratch: Path) -> dict:
    """Phase 32: GPT-2 small f32 beam search through the generate CLI (2
    prompts x BEAM_PROMPT_LEN, BEAM_WIDTH beams, BEAM_NEW new tokens) by
    KV cache, by dense refeed and by refeed through the flash kernel (#1
    counted at 12 x BEAM_NEW); ids equal, or parted at a tie of the parting
    step's candidate scores; then ``--draft-model gpt_nano --draft-len 4``
    against greedy ``generate``."""
    import torch

    from distributeddeeplearning_tpu_torch import generate as gen_cli

    npz = scratch / "gpt2_small.npz"
    if not npz.exists():
        np.savez(npz, **seeded_flax_params("gpt2_small", SEED))
    nano = scratch / "gpt_nano.npz"
    np.savez(nano, **seeded_flax_params("gpt_nano", SEED + 32,
                                        vocab_size=VOCAB))
    rng = np.random.default_rng(SEED + 32)
    prompts = rng.integers(0, VOCAB, (2, BEAM_PROMPT_LEN)).tolist()
    rows = [x for p in prompts for x in ("--prompt-ids",
                                         ",".join(map(str, p)))]
    base = ["--model", "gpt2_small", "--params", str(npz), "--max-new-tokens",
            str(BEAM_NEW), "--num-beams", str(BEAM_WIDTH)]
    runs, seconds, counted = {}, {}, {}
    for label, extra in (("cached", ["--use-cache"]), ("refeed", []),
                         ("refeed_flash", ["--attn", "flash"])):
        reset_counts(kernels)
        t0 = time.perf_counter()
        runs[label] = run_cli(base + rows + extra)
        torch.cuda.synchronize()
        seconds[label] = time.perf_counter() - t0
        launches = counted[label] = read_counts(kernels)
        want = ({"flash_attention_fwd": 12 * BEAM_NEW}
                if label == "refeed_flash" else {})
        got = {k: v for k, v in launches.items() if v}
        if got != want:
            failures.append(f"beam {label}: kernel launches {got}, want "
                            f"{want}")
    model = gen_cli.load_model("gpt2_small", str(npz), attn="dense")
    ties = []
    for a, b in (("cached", "refeed"), ("refeed", "refeed_flash"),
                 ("cached", "refeed_flash")):
        for row, prompt in enumerate(prompts):
            x, y = runs[a][row], runs[b][row]
            if x == y:
                continue
            tie = beam_tie(model, prompt, x, y)
            ties.append({"runs": [a, b], "prompt": row, **tie})
            if not tie["tie"]:
                failures.append(f"beam {a} and {b} part on prompt {row}: "
                                f"{tie}")
    record = {"seconds": seconds, "beam_launches": counted["refeed_flash"],
              "equal": all(runs["cached"][r] == runs[k][r]
                           for k in runs for r in range(len(prompts))),
              "ties": ties}
    spec_seconds, checks = [], []
    for prompt in prompts:
        t0 = time.perf_counter()
        out = run_cli(["--model", "gpt2_small", "--params", str(npz),
                       "--max-new-tokens", str(BEAM_NEW), "--prompt-ids",
                       ",".join(map(str, prompt)), "--draft-model",
                       "gpt_nano", "--draft-params", str(nano),
                       "--draft-len", "4"])[0]
        spec_seconds.append(time.perf_counter() - t0)
        check = greedy_check(model, prompt, out[len(prompt):], BEAM_NEW)
        checks.append(check)
        if not (check["same"] or check["tie"]):
            failures.append(f"speculative generate parts from greedy: "
                            f"{check}")
    record.update(spec_seconds=spec_seconds, spec_checks=checks)
    log(f"# beam and speculative generation (gpt2_small f32, 2 x "
        f"{BEAM_PROMPT_LEN} prompts, {BEAM_WIDTH} beams, {BEAM_NEW} new): "
        + json.dumps(record))
    del model
    torch.cuda.empty_cache()
    return record


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
        dense = timed("densenet121_train", phase_densenet_train, kernels,
                      failures)
        large = timed("resnet50_large_batch", phase_large_batch, kernels,
                      failures)
        log("# one bf16 step at batch 256 (DenseNet-121) and 512 (ResNet-50) "
            "(wall us, busy us, peak GB): " + json.dumps({
                "densenet121 mixed": [dense["profile"].get("wall_us"),
                                      dense["profile"].get("device_busy_us"),
                                      dense["profile"].get("peak_memory_gb")],
                "resnet50 sgd --fused-block --fused-conv3": [
                    conv3["profile"].get("wall_us"),
                    conv3["profile"].get("device_busy_us"), None],
                "resnet50 " + " ".join(RAMP_FLAGS): [
                    large["profile"].get("wall_us"),
                    large["profile"].get("device_busy_us"),
                    large["profile"].get("peak_memory_gb")]}))
        timed("scaled_vs_unscaled_step", phase_scaled_step, failures)
        timed("dp_train", phase_dp_train, kernels, failures, scratch)
        timed("dp_vs_one_card_step", phase_dp_bitwise, failures, scratch)
        timed("resnet50_lars_32k", phase_lars_32k, kernels, failures)
        timed("token_shards", phase_token_shards, kernels, failures,
              scratch, train)
        model_rows = timed("bert_vit_rows", phase_model_rows, fa, failures)
        bert = timed("bert_base_mlm_train", phase_bert_train, kernels,
                     failures, scratch)
        vit = timed("vit_b16_train", phase_vit_train, kernels, failures)
        timed("bert_vit_flash_vs_dense_step", phase_model_steps, failures)
        token_dp = timed("token_dp_train", phase_token_dp_train, kernels,
                         failures)
        timed("token_dp_vs_one_card_step", phase_token_dp_bitwise, failures,
              scratch)
        timed("accum_vs_one_step", phase_accum_step, failures)
        served = timed("serve", phase_serve, kernels, failures, scratch)
        timed("serve_spec", phase_serve_spec, kernels, failures, scratch,
              served)
        timed("serve_traced", phase_serve_traced, kernels, failures,
              scratch, served)
        beam = timed("beam_spec_generate", phase_beam_spec, kernels,
                      failures, scratch)
    finally:
        shutil.rmtree(scratch, ignore_errors=True)
    log(f"# total: {time.perf_counter() - t_start:.2f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke: FAILED: {f}", file=sys.stderr)
        return 1

    # Flash rows: the GPT-2 training shape, launches from its training run,
    # with BERT-base's and ViT-B/16's shapes and runs beside them.
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
            # This slice's paths and shapes beside the GPT-2 training
            # path's.
            extra["launches_by_path"] = {
                "gpt2_train": launches[k["name"]],
                "bert_mlm_synthetic": bert["synthetic"]["launches"][
                    k["name"]],
                "bert_mlm_shards": bert["shards"]["launches"][k["name"]],
                "vit_b16": vit["launches"][k["name"]],
                "bert_mlm_accum8_torchrun": token_dp["launches"].get(
                    k["name"]),
                "gpt2_beam_refeed_flash": beam["beam_launches"][
                    k["name"]]}
            for shape, by_kernel in model_rows.items():
                extra[f"{shape}_shape"] = {
                    key: by_kernel[k["name"]].get(key) for key in (
                        "max_abs_err", "ms", "ms_rate0", "plain_ms",
                        "bound_ms", "bound_by", "library_ms")}
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
    parser.add_argument(
        "--serve-ab", metavar="CHECKOUT", nargs="+",
        help="only serve phase 29's requests with the port of one CHECKOUT "
        "and of another (default: this one), in turns (first, second, "
        "second, first), each in a process of its own: untraced, and, where "
        "the checkout has them, traced and speculative, in turns")
    parser.add_argument("--serve-run", metavar="CHECKOUT",
                        help=argparse.SUPPRESS)
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
    if cli.serve_run:
        sys.exit(serve_run(cli.serve_run))
    if cli.serve_ab:
        if len(cli.serve_ab) > 2:
            sys.exit("--serve-ab takes one or two checkouts")
        sys.exit(serve_ab(cli.serve_ab[0],
                          (cli.serve_ab[1:] or [str(ROOT)])[0]))
    sys.exit(main())
