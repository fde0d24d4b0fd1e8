"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the device and its power limit;
2. builds every CUDA kernel (``_build.KERNELS``: the flash-attention
   forward and backward, the Swin window-attention core forward and
   backward, the window GEMM, talking heads, the fused attention block
   and the fused MLP) from the sources in the checkout
   (``nvcc``, ``sm_90a``, one process per source, all started together)
   and prints each kernel's registers, shared memory and spills;
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it, and times kernel, plain
   version and the PyTorch library call that computes the same function
   (where there is one): the flash kernels at the dino_vitb8, DeiT-base
   and dino_vits16 shapes, with their launch plans, each launch's device
   time from the profiler, SDPA's device time and backend, and the card's
   clocks before and after the timing; the
   window-attention core (row 5, with its device time, plan and bound),
   its backward (row 6) and the window blocks B8 and B9 (rows 8 and 9,
   each launch of their chains with its own device time from one
   profiler pass, and B9's four window-GEMM launches each held alone
   against its plain composition, with TFLOP/s, bound share, cuBLAS's
   time for the same product and index_select + linear) at all four
   stages of swin_base_384 bs32, shifted and unshifted, at swin_tiny's
   window-7 stage 1 and at a ragged small shape (the window GEMM and the
   core pass the same ptxas gate as B12); the gradients of B8 and B9
   against autograd through their plain versions at the headline,
   window-7 and ragged shapes; the talking-heads kernels (rows 10 and
   11; each of their three launches timed) at the attention shapes of cait_s24_224 bs32, xxs24, s24_384,
   m36_384, m48_448 and a ragged one through the model's qkv entry, and
   the headline through the (B, N, C) entry; the fused MLP (row 12) at DeiT-base, dino_vitb8
   and cait_s24_224 bs32, swin_base_384 stages 1 and 4, a ragged shape
   and T < 64, with its launch plan, TFLOP/s, bound share and ptxas
   report (no spills, no serialised wgmma), its two row layouts timed
   against each other at swin_base_384 stages 1 and 2, and its
   gradients at the headline; the flat
   window block (row 7) at the Swin block cases, with its gradients at
   the headline;
4. exports a full-width dino_vitb8 @224 classifier with seeded weights
   through ``vit_torch_tpu_torch.cli.export``, serves it with
   ``BundleServer`` on the card, sends concurrent HTTP requests, checks the
   replies, checks the logits against the same weights run through the
   plain attention, and checks that every attention went through the
   kernel (launch count = layers x dispatches);
5. fine-tunes dino_vitb8 @224 bs32 for one epoch of the synthetic data
   through ``vit_torch_tpu_torch.cli.main`` (adamw, 16 train and 16 eval
   steps) and checks the kernels' launch counts and the stats JSON; then
   runs the cached linear eval, whose backbone never runs a backward;
6. times the steady-state finetune step (CUDA events), profiles one step
   by kernel group, and compares loss and gradients of one bs8 step on the
   kernel path with the same step on the plain attention;
7. Swin: exports and serves swin_base_patch4_window12_384_22k @384 over
   HTTP as in 4 (every block through B9: launches = 24 x dispatches, the
   logits held against the plain versions); linear-evaluates it @384 bs32
   for one synthetic epoch through ``vit_torch_tpu_torch.cli.main_swin``
   (B8 takes the 23 train-mode blocks whose drop-path is active, B9 block
   0 and every eval block) and runs the cached linear eval (B9 only);
   fine-tunes it @384 bs32 for one synthetic epoch through
   ``cli.main_swin`` (B9 with grad for block 0, B8 with grad for the
   other 23, every attention backward through B6; no plain version
   launched); times the steady-state linear-eval and fine-tune steps and
   a bs32 eval forward and profiles both steps; holds one bs8 fine-tune
   step on the kernels against the same step on the plain versions;
8. CaiT: exports and serves cait_s24_224 @224 over HTTP as in 4 (every
   talking-heads block through the kernel: launches = 24 x dispatches, the
   logits held against the plain version, LayerScale gates raised from
   their 1e-5 init to CAIT_GAMMA so that the comparison holds something);
   linear-evaluates it (plain and
   cached) and fine-tunes it @224 bs32 for one synthetic epoch through
   ``cli.main`` (24 counted calls of the talking-heads kernels, three
   launches each, per backbone forward, no flash or
   window kernel, no plain talking-heads forward; the fine-tune's
   backward recomputes each block through the plain version, as the JAX
   backward does); times the steady-state fine-tune and linear-eval steps
   and a bs32 eval forward, profiles the steps; holds one bs8 fine-tune
   step against the same step on the plain version;
9. the fused attention block: holds B3 (``attention_block``) and B4
   (``attention_block_packed``, its qkv output too) against their plain
   versions at dino_vits16 @224 bs64 and bs128, dino_vitb8 @224 bs32, the
   dino_vitb8 @32 bs128 pack and ragged shapes, their gradients at the
   headline shapes, and times each beside the port's unfused path (cuBLAS
   + flash + cuBLAS) and cuBLAS + SDPA, with the qkv product's and the
   attention kernel's own device times from one profiler pass, the
   library's device time, the plan and the card's clocks and power read
   around the timing; exports and serves
   dino_vits16 @224 over HTTP with B3 on (buckets 1/8/64, launches = 12 x
   dispatches); linear-evaluates (plain and cached) and fine-tunes it at
   bs64 through ``cli.main`` with B3 on (12 launches per backbone
   forward; the fine-tune's backward recomputes through the flash
   kernels); fine-tunes dino_vitb8 @32 bs128 (bench config 3) with B4
   on; times the steady-state steps and the eval forward with each kernel
   on and off, and holds one bs8 step of each against the plain versions;
10. DeiT with the fused MLP on (``VITX_FUSED_MLP=1``): exports and serves
   deit_base_distilled_patch16_224 @224 over HTTP (launches of the fused
   MLP and the flash forward = 12 x dispatches, logits held against the
   plain versions); linear-evaluates (plain and cached) and fine-tunes it
   at bs32 through ``cli.main`` (8 + 8 steps; the cached run features
   both whole splits); then, with ``VITX_FUSED_SPATIAL=0``,
   linear-evaluates swin_base_384 through ``cli.main_swin`` (4 + 4
   steps: 23 flat window-block launches per train step, B9 for block 0
   and the eval steps, no B8); times the DeiT linear-eval step, the eval
   forward and the fine-tune step with the fused MLP off, on, on, off,
   and holds one bs8 DeiT step against the plain versions;
11. the conv families (no kernel of their own): exports and serves
   xcit_small_24_p16 with ``VITX_FUSED_MLP=1`` (26 B12 launches per
   dispatch) and resnext50_32x4d (no launch) @224 over HTTP, their LayerScale
   gates raised and BN statistics drawn away from init in the bundle, the
   served logits held against an fp32 forward of the bundle on the CPU;
   linear-evaluates (plain and cached) and fine-tunes both @224 bs32 for
   one synthetic epoch through ``cli.main`` (XCiT under the flag); times
   XCiT's fine-tune step with B12 off, on, on, off (B12 itself at XCiT's
   shapes is in 3's checks) and ResNeXt's fine-tune step, each with its
   profile, peak memory and MFU, and ResNeXt's eval forward with the
   conv+BN fold on and off in turns (the fold's CUDA default);
12. prints one JSON line with each kernel's numbers, then the card's name
   and power limit from nvidia-smi, then
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import base64
import http.client
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from unittest import mock

import numpy as np

# kernel check: max |kernel - plain| on bf16 outputs of order 1; both
# accumulate in fp32 and round P to bf16, so they differ by summation order
# and the final bf16 rounding (~4e-3 of |O|)
KERNEL_ATOL = 2e-2
# served logits, kernel vs plain attention through the same bf16 model:
# rounding differences in 12 attention layers, carried through the
# residual stream, LayerNorms and the head
LOGITS_ATOL = 5e-2
# backward kernel check: max |kernel - plain| over dq, dk, dv, relative to
# max |plain| of the same gradient (their scale grows with N).  Kernel and
# plain agree on every rounding point (P to bf16 for dV, dS to bf16) but
# the kernel takes Di = rowsum(dO o O) from the bf16 O and P from the
# forward's LSE, so a dS element can land one bf16 ulp (2^-8 = 0.4%) away
# and sums of hundreds of such terms run in another order; a few 1e-3 of
# max |plain| is expected.  At N = 1 dQ and dK vanish (P = 1, so
# dP - Di = 0) and the kernel leaves only its Di rounding (~1e-6), so the
# denominator is floored at BWD_FLOOR
BWD_RTOL = 2e-2
BWD_FLOOR = 1e-3
# forward LSE vs the plain fp32 logsumexp of the same bf16 scores: both
# fp32, they differ by summation order and exp2/log2 rounding (~1e-6 of
# values near log N)
LSE_ATOL = 1e-3
# one bs8 finetune step of the bf16 model, flash kernels vs the plain
# attention on the same weights and batch: both round activations to bf16
# after every op, but the kernels round P and dS at other points than
# autograd through the plain version does; carried through 12 layers that
# moves the fp32 loss by ~1e-3 and each parameter's gradient by ~1% of its
# norm
STEP_LOSS_ATOL = 2e-2
STEP_GRAD_RTOL = 5e-2
# window-attention core: as KERNEL_ATOL (bf16 outputs of order 1, fp32
# sums in another order, P rounded to bf16 at the same point)
WINDOW_ATOL = 2e-2
# window blocks B8 and B9: max |kernel - plain| relative to max |plain|.
# Both round at the same points, but an fp32 sum in another order can move
# a rounded qkv, head output, LN output or hidden value by one bf16 ulp
# (2^-8 = 0.4%), which the next product carries; B9's output holds the
# residual stream of order 1-4
BLOCK_RTOL = 3e-2
# served Swin logits, kernels vs plain versions through the same bf16
# model: such one-ulp differences in 24 blocks, carried through the
# residual stream, the final LayerNorm and the head; relative to
# max |plain logit|
SWIN_LOGITS_RTOL = 5e-2
# window-attention backward (B6) vs its plain version: dq, dk and dv as
# BWD_RTOL / BWD_FLOOR (the same rounding points, bf16 P and dS, fp32 sums
# in another order).  dbias relative to max |plain dbias|: both sum the
# unrounded fp32 dS over all windows, the kernel per chunk then over the
# chunks, so they differ by summation order over up to 2048 windows
WINDOW_DBIAS_RTOL = 1e-2
# B8 / B9 gradients through their Functions (chain forward, B6, bf16
# matmuls; B9 recomputes with the JAX backward's bf16 bias adds) vs
# autograd through the plain versions (fp32 products rounded where the
# forward rounds, so autograd rounds the gradient at each cast back):
# relative to max |plain| of each gradient; one-ulp bf16 differences
# (2^-8) carried through two products and the attention backward
BLOCK_GRAD_RTOL = 5e-2
# talking heads (rows 10 and 11) vs the plain version: max |kernel - plain|
# relative to max |plain|.  Both round the mixed weights A to bf16 before
# PV and sum in fp32, in another order, so an A element can land one bf16
# ulp (2^-8) away, which PV carries over the N keys
TH_RTOL = 2e-2
# served CaiT logits, kernel vs plain through the same bf16 model: such
# one-ulp differences in 24 blocks, through the residual stream, the class
# attention, the final LayerNorm and the head; relative to max |plain
# logit|
CAIT_LOGITS_RTOL = 5e-2
# the LayerScale gates of the CaiT that serving and the bs8 step compare:
# seeded at init_scale = 1e-5, a block's branch vanishes under the bf16
# residual (x + 1e-5 * y rounds to x), and the comparison with the plain
# version would hold nothing; at 0.1 every block moves the stream
CAIT_GAMMA = 0.1
H100_BF16_FLOPS = 989e12          # dense tensor-core peak, SXM
H100_BYTES_PER_S = 3.35e12
ARCH, IMAGE_SIZE, CLASSIFIER, BUCKETS = "dino_vitb8", 224, "512,10", "1,8,32"
TRAIN_BS, SYNTHETIC_N = 32, 512
TRAIN_ARGS = ["--dataset", "synthetic", "--arch", ARCH, "--image_size",
              str(IMAGE_SIZE), "--bs", str(TRAIN_BS), "--epoch", "1",
              "--opt", "adamw", "--lr", "1e-4", "--fc", "512"]
# the flash shapes: dino_vitb8 @224 bs32 (the headline), then the
# default attention of DeiT-base bs32 and dino_vits16 @224 bs64
ATTN_SHAPES = [(32, 12, 785, 64), (8, 12, 197, 64), (2, 2, 65, 32),
               (1, 1, 1, 64), (32, 12, 197, 64), (64, 6, 197, 64)]
# the dino_vitb8 finetune shapes at 224 px bs32 and 32 px bs128, small
# ragged ones, DeiT-base bs32 and dino_vits16 @224 bs64
BWD_SHAPES = [(32, 12, 785, 64), (128, 12, 17, 64), (8, 12, 197, 64),
              (2, 2, 65, 32), (1, 1, 1, 64), (32, 12, 197, 64),
              (64, 6, 197, 64)]
# the backward's three launches, in order, as the profiler names them
FLASH_BWD_KERNELS = ("flash_bwd_preprocess_kernel", "flash_bwd_kernel",
                     "flash_bwd_convert_kernel")
SWIN_ARCH, SWIN_SIZE, SWIN_DEPTH = "swin_base_patch4_window12_384_22k", 384, 24
SWIN_TRAIN_ARGS = ["--dataset", "synthetic", "--arch", SWIN_ARCH,
                   "--image_size", str(SWIN_SIZE), "--bs", str(TRAIN_BS),
                   "--epoch", "1", "--opt", "adamw", "--lr", "1e-3", "--fc",
                   "512"]
SWIN_FINETUNE_ARGS = [a if a != "1e-3" else "1e-4" for a in SWIN_TRAIN_ARGS]
# (B, H, W, C, window, shift) of the Swin blocks checked: the four stages of
# swin_base_384 at bs32, shifted and unshifted (stage 4 is one window, never
# shifted); swin_tiny's stage 1 at 224 px (window 7, N = 49); a ragged
# window 5 on a 10 x 15 map.  The first is the headline shape.
CAIT_ARCH, CAIT_SIZE, CAIT_DEPTH = "cait_s24_224", 224, 24
CAIT_TRAIN_ARGS = ["--dataset", "synthetic", "--arch", CAIT_ARCH,
                   "--image_size", str(CAIT_SIZE), "--bs", str(TRAIN_BS),
                   "--epoch", "1", "--opt", "adamw", "--lr", "1e-4", "--fc",
                   "512"]
# (B, H, N, D) of the talking-heads attentions checked: cait_s24_224 bs32
# (the headline), xxs24_224 bs32, s24_384 and m36_384 bs8, m48_448 bs4 (N =
# 784, 16 heads: the largest of the zoo) and a ragged shape; the headline
# again through the (B, N, C) entry
TH_SHAPES = [(32, 8, 196, 48), (32, 4, 196, 48), (8, 8, 576, 48),
             (8, 16, 576, 48), (4, 16, 784, 48), (2, 4, 37, 48)]
# talking heads' kernels as the profiler names them, and its three launches
# in order: the key parts' softmax statistics and the mixed weights A (both
# talking_heads_mix_kernel), then O = A V
TH_KERNELS = ("talking_heads_mix_kernel", "talking_heads_pv_kernel")
TH_LAUNCHES = ("statistics", "mix", "pv")
# the fused attention block (rows 3 and 4): dino_vits16 @224 (N = 197, C =
# 384, 6 heads of 64) through its serving, linear-eval and fine-tune paths
# at bs64 with B3 on; dino_vitb8 fine-tuned at 32 px, bs128 (bench.py config
# 3, N = 17) with B4 on (VITX_PACKED_ATTN=1)
VITS_ARCH, VITS_SIZE, VITS_BS, VITS_DEPTH = "dino_vits16", 224, 64, 12
VITS_BUCKETS = "1,8,64"
VITS_TRAIN_ARGS = ["--dataset", "synthetic", "--arch", VITS_ARCH,
                   "--image_size", str(VITS_SIZE), "--bs", str(VITS_BS),
                   "--epoch", "1", "--opt", "adamw", "--lr", "1e-4", "--fc",
                   "512"]
SMALL_SIZE, SMALL_BS = 32, 128
SMALL_TRAIN_ARGS = ["--dataset", "synthetic", "--arch", ARCH, "--image_size",
                    str(SMALL_SIZE), "--bs", str(SMALL_BS), "--epoch", "1",
                    "--opt", "adamw", "--lr", "1e-4", "--fc", "512"]
# (B, N, C, heads) of the B3 checks: dino_vits16 @224 bs64 (the headline)
# and bs128, dino_vitb8 @224 bs32, a ragged shape; of the B4 checks:
# dino_vitb8 @32 bs128 (the headline) and a ragged pack
AB_SHAPES = [(64, 197, 384, 6), (128, 197, 384, 6), (32, 785, 768, 12),
             (3, 37, 128, 2)]
AB_PACKED_SHAPES = [(128, 17, 768, 12), (7, 5, 128, 4)]
# B3 / B4 vs their plain versions: max |kernel - plain| relative to
# max |plain|.  Both round qkv, P and each head's output to bf16 at the same
# points, but fp32 sums in another order (and the kernel's online softmax
# over 64-key tiles, which rounds P against the running max) can move one
# of them by a bf16 ulp (2^-8), which the projection carries
ATTN_BLOCK_RTOL = 3e-2
# their gradients through the Functions (B3: the flash recompute with the
# JAX backward's bf16 bias adds; B4: the analytic backward) vs autograd
# through the plain versions: relative to max |plain| of each gradient, as
# BLOCK_GRAD_RTOL
ATTN_BLOCK_GRAD_RTOL = 5e-2
# served dino_vits16 logits, B3 vs its plain version through the same bf16
# model: such one-ulp differences in 12 blocks through the residual stream,
# the final LayerNorm and the head; relative to max |plain logit| (the
# seeded head's logits are small)
VITS_LOGITS_RTOL = 5e-2
# the fused MLP (row 12): deit_base_distilled_patch16_224 @224 bs32 (C 768,
# 12 heads of 64, N = 198, hidden 3072) through its serving, linear-eval
# (plain and cached) and fine-tune paths with VITX_FUSED_MLP=1: 12 launches
# per backbone forward.  The CLI runs take 8 + 8 steps (--scan 0 with
# limits); the cached run features both whole splits (16 + 16 forwards)
DEIT_ARCH, DEIT_SIZE, DEIT_DEPTH = "deit_base_distilled_patch16_224", 224, 12
DEIT_SAMPLES = 256
DEIT_TRAIN_ARGS = ["--dataset", "synthetic", "--arch", DEIT_ARCH,
                   "--image_size", str(DEIT_SIZE), "--bs", str(TRAIN_BS),
                   "--epoch", "1", "--opt", "adamw", "--lr", "1e-4", "--fc",
                   "512", "--scan", "0", "--limit_train", str(DEIT_SAMPLES),
                   "--limit_test", str(DEIT_SAMPLES)]
# (T, C, hidden, out, biases) of the B12 checks: DeiT-base bs32 (the
# headline), dino_vitb8 @224 bs32, cait_s24_224 bs32 (also xcit_small_24_p16
# bs32's XCA blocks, 32 x 196 tokens of 384), swin_base_384 stage 1 bs32
# (the byte-bound case), a ragged T with out != C and no biases,
# swin_base_384 stage 4 bs32 (C = 1024: two output slabs, the one plan that
# recomputes fc1), T < 64 (one partly empty row tile) and
# xcit_small_24_p16 bs32's class-attention blocks (the CLS tokens only)
MLP_SHAPES = [(6336, 768, 3072, 768, True), (25120, 768, 3072, 768, True),
              (6272, 384, 1536, 384, True), (294912, 128, 512, 128, True),
              (1000, 256, 1024, 520, False), (4608, 1024, 4096, 1024, True),
              (40, 384, 1536, 384, True), (32, 384, 1536, 384, True)]
# (T, C, hidden, out) at which B12's two row layouts are timed against
# each other: swin_base_384 stages 1 and 2 at bs32, where launch_plan
# takes 128-row tiles (they fill the card), and stage 2 at bs1, where it
# takes 64-row tiles (twice the blocks)
MLP_LAYOUT_SHAPES = [(294912, 128, 512, 128), (73728, 256, 1024, 256),
                     (2304, 256, 1024, 256)]
# B12 vs its plain version, max |kernel - plain| relative to max |plain|:
# both round the hidden activation once and sum in fp32 in another order,
# so a hidden value can land one bf16 ulp (2^-8) away, which fc2 carries;
# its gradients (the recompute through cuBLAS) as BLOCK_GRAD_RTOL
MLP_RTOL = 3e-2
MLP_GRAD_RTOL = 5e-2
# served DeiT logits, B12 and flash vs their plain versions through the same
# bf16 model: one-ulp differences in 12 blocks through the residual stream,
# the final LayerNorm and the head; relative to max |plain logit|
DEIT_LOGITS_RTOL = 5e-2
# the Swin linear eval with the flat window block (B7,
# VITX_FUSED_SPATIAL=0): 4 + 4 steps
SWIN_FLAT_SAMPLES = 128
# the conv families (ROADMAP A5), at the published manifests' archs @224
# bs32: xcit_small_24_p16 (no kernel of its own; with VITX_FUSED_MLP=1 its
# 24 XCA and 2 class-attention MLPs take B12, 26 launches a forward) and
# resnext50_32x4d (cuDNN convs, grouped 3x3s of 32 groups; no kernel).
# Served logits are held against an fp32 forward of the same weights on
# the CPU, relative to max |CPU logit|: bf16 activations through 24 (or 16
# bottleneck) blocks, the final norm or pool and the head
XCIT_ARCH, XCIT_SIZE, XCIT_MLPS = "xcit_small_24_p16", 224, 26
RESNEXT_ARCH, RESNEXT_SIZE = "resnext50_32x4d", 224
CONV_LOGITS_RTOL = 5e-2
# the served conv models' state: XCiT's LayerScale gates raised from their
# 1e-5 init (as CAIT_GAMMA) and every BN's running statistics drawn away
# from 0 and 1, so that the bundle's statistics change the logits
CONV_GAMMA = 0.1
SWIN_BLOCKS = [(32, 96, 96, 128, 12, 6), (32, 96, 96, 128, 12, 0),
               (32, 48, 48, 256, 12, 6), (32, 48, 48, 256, 12, 0),
               (32, 24, 24, 512, 12, 6), (32, 24, 24, 512, 12, 0),
               (32, 12, 12, 1024, 12, 0), (32, 56, 56, 96, 7, 3),
               (2, 10, 15, 64, 5, 2)]


def _say(*parts) -> None:
    print(*parts, flush=True)


def _time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(flops, nbytes):
    """(least ms, what bounds it): the operations at the dense bf16 peak
    or the bytes at the memory rate, whichever takes longer."""
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _attention_bound_ms(B, H, N, D):
    return _bound(4 * B * H * N * N * D,     # QK^T and PV, 2 flops per MAC
                  4 * B * H * N * D * 2)     # q, k, v read once, o written


def _bwd_bound_ms(B, H, N, D):
    return _bound(10 * B * H * N * N * D,    # S, dP, dV, dQ, dK products
                  8 * B * H * N * D * 2 + B * H * N * 4)  # + the fp32 LSE


def _window_bwd_bound_ms(Bn, H, N, D):
    return _bound(10 * Bn * H * N * N * D,   # S, dP, dV, dQ, dK products
                  7 * Bn * N * H * D * 2)    # q, k, v, dO read; dq, dk, dv


def check_flash_bwd_kernel(shape, seed):
    """Backward kernel vs plain version on one shape, fed as the model
    feeds it: q, k, v strided views into one (B, N, 3, H, D) qkv tensor,
    through ``flash_attention_qkv``'s autograd Function, whose backward
    writes one (B, N, 3, H, D) gradient.  Also holds the forward's LSE
    against the plain logsumexp; times the backward on CUDA events (the
    card's clocks read just before and after) and each of its three
    launches' device time from one profiler pass (preprocess, main,
    convert), the plain backward, SDPA's backward (events, device time,
    the backend it took) and the forward with the LSE written."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import flash_attention as fa
    B, H, N, D = shape
    gen = torch.Generator(device="cuda").manual_seed(1000 + seed)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    dout = torch.randn((B, N, H, D), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    scale = D ** -0.5
    qkv.requires_grad_(True)
    out = fa.flash_attention_qkv(qkv, scale=scale)
    (dqkv,) = torch.autograd.grad(out, qkv, dout)
    qkv = qkv.detach()
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    do = dout.transpose(1, 2)
    o, lse = fa.flash_attention_fwd(q, k, v, scale=scale, return_lse=True)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bwd_reference(q, k, v, do, scale=scale)
    errs, abs_err = [], 0.0
    for got, want in zip(dqkv.unbind(2), ref):
        want = want.float()
        got = got.transpose(1, 2).float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"flash_attention_bwd {shape}: non-finite")
        err = (got - want).abs().max().item()
        abs_err = max(abs_err, err)
        errs.append(err / max(want.abs().max().item(), BWD_FLOOR))
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    lse_err = (lse - torch.logsumexp(s, dim=-1)).abs().max().item()
    del s
    rel = max(errs)
    if not (rel <= BWD_RTOL and lse_err <= LSE_ATOL):
        raise AssertionError(f"flash_attention_bwd {shape}: dq/dk/dv error "
                             f"relative to max|plain| {errs} (limit "
                             f"{BWD_RTOL}), lse max abs err {lse_err} "
                             f"(limit {LSE_ATOL})")
    big = B * H * N * N > 1e8
    dq, dk, dv = (x.transpose(1, 2) for x in dqkv.unbind(2))

    def run():
        fa.flash_attention_bwd(q, k, v, o, lse, do, scale=scale, dq=dq,
                               dk=dk, dv=dv)

    smi = [_smi_sample()]
    ms = _time_ms(run, iters=20 if big else 100)
    smi.append(_smi_sample())
    # the card's profiler now and then drops an event from a pass (a
    # kernel read 0.9 times a call over 10 calls); a pass whose counts are
    # off is made again, as _launch_times does, up to 3 passes
    for _ in range(3):
        split = _device_times(run, FLASH_BWD_KERNELS)
        if all(t > 0 and n == 1 for t, n in split):
            break
    else:
        raise AssertionError(f"flash_attention_bwd {shape}: the profiler "
                             f"did not see each launch once a call: "
                             f"{split}")
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, do, scale=scale), iters=3 if big else 20)
    qs, ks, vs = (x.contiguous().requires_grad_(True) for x in (q, k, v))
    dos = do.contiguous()
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

    def library():
        return torch.autograd.grad(o_lib, (qs, ks, vs), dos,
                                   retain_graph=True)

    library_ms = _time_ms(library, iters=20 if big else 100)
    library_device_ms = _device_ms(library, "")   # every kernel it runs
    fwd_lse_ms = _time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, scale=scale, out=o, return_lse=True),
        iters=20 if big else 100)
    bound_ms, bound_by = _bwd_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "rel_err_dq_dk_dv": errs,
           "max_abs_err": abs_err,
           "max_abs_err_lse": lse_err, "ms": ms,
           "device_ms": sum(t for t, _ in split),
           "device_ms_preprocess_main_convert": [t for t, _ in split],
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_device_ms": library_device_ms,
           "library_backend": _library_backend(library),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "plan": fa.launch_plan(B, H, N, D, backward=True)._asdict(),
           "fwd_with_lse_ms": fwd_lse_ms,
           "fwd_bound_ms": _attention_bound_ms(B, H, N, D)[0],
           "smi_before_after_events": smi}
    _say("kernel check flash_attention_bwd", json.dumps(row))
    return row


def check_flash_kernel(shape, seed):
    """Kernel vs plain version on one shape, through both entries: the
    (B, N, H, D) one fed as the model feeds it (q, k, v strided views into
    one (B, N, 3, H, D) qkv tensor) and the (B, H, N, D) one on contiguous
    inputs.  Times the first, as the serving path calls it, on CUDA events
    (the card's clocks read just before and after) and its device time
    from the profiler; the plain version; SDPA on events and on the
    device, with the backend it took."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import flash_attention as fa
    B, H, N, D = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    q, k, v = qkv.unbind(2)                    # (B, N, H, D) views
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    scale = D ** -0.5
    out = fa.flash_attention(q, k, v, scale=scale).transpose(1, 2)
    # and the (B, H, N, D) entry on contiguous inputs
    out_bhnd = fa.flash_attention_bhnd(qt.contiguous(), kt.contiguous(),
                                       vt.contiguous(), scale=scale)
    torch.cuda.synchronize()
    ref = fa.flash_attention_bhnd_reference(qt, kt, vt, scale=scale).float()
    err = max((o.float() - ref).abs().max().item() for o in (out, out_bhnd))
    if not (torch.isfinite(out).all() and torch.isfinite(out_bhnd).all()
            and err <= KERNEL_ATOL):
        raise AssertionError(f"flash_attention_fwd {shape}: max abs err "
                             f"{err} > {KERNEL_ATOL}")
    big = B * H * N * N > 1e8

    def run():
        return fa.flash_attention(q, k, v, scale=scale)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    smi = [_smi_sample()]
    ms = _time_ms(run, iters=20 if big else 100)
    smi.append(_smi_sample())
    ((device_ms, seen),) = _device_times(run, ("flash_fwd_kernel",))
    if not (device_ms > 0 and seen == 1):
        raise AssertionError(f"flash_attention_fwd {shape}: the profiler "
                             f"saw {seen} launches a call, {device_ms} ms")
    plain_ms = _time_ms(lambda: fa.flash_attention_bhnd_reference(
        qt, kt, vt, scale=scale), iters=5 if big else 20)
    library_ms = _time_ms(library, iters=20 if big else 100)
    bound_ms, bound_by = _attention_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "max_abs_err": err, "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_device_ms": _device_ms(library, ""),
           "library_backend": _library_backend(library),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "plan": fa.launch_plan(B, H, N, D)._asdict(),
           "smi_before_after_events": smi}
    _say("kernel check flash_attention_fwd", json.dumps(row))
    return row


def _swin_mask(case, device):
    """The (nW, N, N) shifted-window mask of a block case, or None."""
    import torch
    from vit_torch_tpu_torch.models.swin import shifted_window_mask
    _, H, W, _, w, shift = case
    if not shift:
        return None
    return torch.from_numpy(shifted_window_mask(H, W, w, shift)).to(device)


def check_window_attention(case, seed):
    """The window-attention core (row 5) vs its plain version on the
    windows of one block case, fed as the block chains feed it: q, k and v
    strided views into one window-major (Bn, N, 3, H, D) qkv tensor, the
    fp32 bias and the block's real shifted-window mask.  Times kernel, plain
    version and SDPA with the float ``bias + mask`` as ``attn_mask`` (over
    (B, nW, H, N, D) so that the mask broadcasts per window)."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import window_attention as wa
    B, H, W, C, w, shift = case
    heads, N, nW = C // 32, w * w, (H // w) * (W // w)
    Bn = B * nW
    gen = torch.Generator(device="cuda").manual_seed(2000 + seed)
    qkv = torch.randn((Bn, N, 3, heads, 32), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    bias = 0.5 * torch.randn((heads, N, N), generator=gen, device="cuda")
    mask = _swin_mask(case, "cuda")
    q, k, v = qkv.unbind(2)
    out = wa.window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    ref = wa.window_attention_reference(q, k, v, bias, mask).float()
    err = (out.float() - ref).abs().max().item()
    if not (torch.isfinite(out).all() and err <= WINDOW_ATOL):
        raise AssertionError(f"window_attention {case}: max abs err {err} > "
                             f"{WINDOW_ATOL}")
    del ref
    def run():
        return wa.window_attention(q, k, v, bias, mask)

    smi = [_smi_sample()]
    ms = _time_ms(run, iters=20)
    device_ms = _device_ms(run, "window_attn_fwd_kernel")
    smi.append(_smi_sample())
    plain_ms = _time_ms(lambda: wa.window_attention_reference(
        q, k, v, bias, mask), iters=3)
    qs, ks, vs = (x.reshape(B, nW, N, heads, 32).transpose(2, 3).contiguous()
                  for x in (q, k, v))
    add = bias[None, None] + (0 if mask is None else mask[None, :, None])
    add = add.to(torch.bfloat16).expand(B, nW, heads, N, N)

    def library():
        return F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add,
                                              scale=32 ** -0.5)

    library_ms = _time_ms(library, iters=20)
    # the bound: q, k, v and o once, and the fp32 bias and mask once
    plan = wa.core_plan(Bn, N, heads, 1 if mask is None else nW)
    bound_ms, bound_by = _bound(
        4 * Bn * heads * N * N * 32,
        4 * Bn * N * heads * 32 * 2
        + (heads + (0 if mask is None else nW)) * N * N * 4)
    row = {"case": list(case), "shape": [Bn, N, heads, 32],
           "masked": mask is not None, "max_abs_err": err, "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms,
           "library_ms": library_ms,
           "library_device_ms": _device_ms(library, ""),
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / device_ms, "plan": plan._asdict(),
           "smi_before_after": smi}
    _say("kernel check window_attention", json.dumps(row))
    return row


def _cuda_events(fn, iters: int, tries: int = 3):
    """The CUDA kernel events of one torch.profiler pass over ``iters``
    calls of ``fn`` (after one call outside it).  The card's profiler now
    and then records no kernel at all in a short pass (SDPA's backend has
    read "not measured", a flash check has seen no launch, of kernels that
    ran); a pass that recorded none is made again, up to ``tries``
    passes."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return events
    return []


def _library_backend(fn) -> str:
    """The kernel that takes most device time in one call of ``fn``: the
    backend PyTorch picked."""
    evs = _cuda_events(fn, iters=1)
    if not evs:
        return "not measured"
    return max(evs, key=lambda e: e.self_device_time_total).key[:80]


def _device_times(fn, kernels, iters: int = 10):
    """One torch.profiler pass over ``iters`` calls of ``fn``: for each
    entry of ``kernels`` (a name, or a tuple of names), the mean device
    time per call spent in the kernels whose name holds it and the
    launches of them the profiler recorded per call.  The kernels' own
    time, where the CUDA-event time of a loop of calls is set by the
    host's launch rate; entries read from one pass add up to the time of
    all of them."""
    events = _cuda_events(fn, iters)
    times = []
    for kernel in kernels:
        names = (kernel,) if isinstance(kernel, str) else kernel
        hits = [e for e in events if any(n in e.key for n in names)]
        times.append((sum(e.self_device_time_total for e in hits) / 1e3
                      / iters, sum(e.count for e in hits) / iters))
    return times


def _launch_times(fn, launches: int, iters: int = 10, tries: int = 3):
    """One torch.profiler pass over ``iters`` calls of ``fn``, which
    launches ``launches`` kernels a call in a fixed order: each launch's
    kernel name and mean device ms, in order (the chain's launches one by
    one, where several share a kernel's name).  A pass that recorded
    another number of kernels is made again, up to ``tries`` passes; then
    the times read None ("not measured")."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        evs = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        if len(evs) == iters * launches:
            return [(evs[i].name[:60], sum(
                evs[k * launches + i].time_range.end
                - evs[k * launches + i].time_range.start
                for k in range(iters)) / 1e3 / iters)
                for i in range(launches)]
    return [(None, None)] * launches


def _device_ms(fn, kernel, iters: int = 10) -> float:
    """Mean device time per call of ``fn`` spent in the kernels whose name
    holds ``kernel`` (a name, or a tuple of names)."""
    return _device_times(fn, (kernel,), iters)[0][0]


def check_window_attention_bwd(case, seed):
    """The window-attention backward (row 6) vs its plain version on the
    windows of one block case, fed as the B8 Function feeds it: q, k, v
    strided views into one window-major qkv tensor, through
    ``window_attention_qkv``'s autograd Function, whose backward writes one
    (Bn, N, 3, H, D) gradient; the fp32 bias and the block's real mask.
    A second call on the same inputs must give bitwise the same dq, dk, dv
    and dbias (dbias is summed in a fixed order).  Times the kernel (CUDA
    events over a loop of calls, and each launch's own device time from
    one profiler pass: the window pass and the dbias reduction), the plain
    backward, and SDPA's backward twice: over (B, nW, H, N, D) with the
    ``bias + mask`` built from a bias that requires grad (as row 5's
    forward yardstick builds it; SDPA then runs its fp32 math path), and
    over (Bn, H, N, D) views with a contiguous bf16 ``bias + mask`` that
    needs no grad (which SDPA's fused backends take); names the kernel
    SDPA ran in each.  Neither SDPA call computes dbias."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import window_attention as wa
    B, H, W, C, w, shift = case
    heads, N, nW = C // 32, w * w, (H // w) * (W // w)
    Bn = B * nW
    gen = torch.Generator(device="cuda").manual_seed(4000 + seed)
    qkv = torch.randn((Bn, N, 3, heads, 32), generator=gen, device="cuda",
                      dtype=torch.bfloat16, requires_grad=True)
    bias = (0.5 * torch.randn((heads, N, N), generator=gen, device="cuda")
            ).requires_grad_(True)
    dout = torch.randn((Bn, N, heads, 32), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    mask = _swin_mask(case, "cuda")
    dqkv, dbias = torch.autograd.grad(
        wa.window_attention_qkv(qkv, bias, mask), (qkv, bias), dout)
    dqkv2, dbias2 = torch.autograd.grad(
        wa.window_attention_qkv(qkv, bias, mask), (qkv, bias), dout)
    torch.cuda.synchronize()
    bitwise = bool(torch.equal(dqkv, dqkv2) and torch.equal(dbias, dbias2))
    del dqkv2, dbias2
    qkv, bias = qkv.detach(), bias.detach()
    q, k, v = qkv.unbind(2)
    ref = wa.window_attention_bwd_reference(q, k, v, bias, mask, dout)
    errs, abs_err = [], 0.0
    for got, want in zip(dqkv.unbind(2), ref):
        want = want.float()
        if not torch.isfinite(got).all():
            raise AssertionError(f"window_attention_bwd {case}: non-finite")
        err = (got.float() - want).abs().max().item()
        abs_err = max(abs_err, err)
        errs.append(err / max(want.abs().max().item(), BWD_FLOOR))
    db_err = ((dbias - ref[3]).abs().max().item()
              / max(ref[3].abs().max().item(), BWD_FLOOR))
    del ref
    if not (max(errs) <= BWD_RTOL and db_err <= WINDOW_DBIAS_RTOL
            and torch.isfinite(dbias).all() and bitwise):
        raise AssertionError(f"window_attention_bwd {case}: dq/dk/dv error "
                             f"relative to max|plain| {errs} (limit "
                             f"{BWD_RTOL}), dbias {db_err} (limit "
                             f"{WINDOW_DBIAS_RTOL}), bitwise repeat "
                             f"{bitwise}")
    dq, dk, dv = dqkv.unbind(2)

    def run():
        return wa.window_attention_bwd(q, k, v, bias, mask, dout, dq=dq,
                                       dk=dk, dv=dv)

    smi = [_smi_sample()]
    ms = _time_ms(run, iters=20)
    (pass_ms, pass_n), (reduce_ms, reduce_n) = _device_times(
        run, ("window_attn_bwd_kernel", "dbias_reduce_kernel"))
    smi.append(_smi_sample())
    plain_ms = _time_ms(lambda: wa.window_attention_bwd_reference(
        q, k, v, bias, mask, dout), iters=3)
    qs, ks, vs = (x.reshape(B, nW, N, heads, 32).transpose(2, 3)
                  .contiguous().requires_grad_(True) for x in (q, k, v))
    dos = dout.reshape(B, nW, N, heads, 32).transpose(2, 3).contiguous()
    libs = {}
    for name, bias_in in (("grad_bias", bias.detach().requires_grad_(True)),
                          ("bf16_mask", bias)):
        add = bias_in[None, None] + (0 if mask is None
                                     else mask[None, :, None])
        if name == "grad_bias":   # row 5's form: 5-D, a mask with grad
            add = add.to(torch.bfloat16).expand(B, nW, heads, N, N)
            ins, dout_lib = (qs, ks, vs), dos
        else:   # 4-D views and a contiguous mask, as the fused backends take
            add = add.to(torch.bfloat16).expand(B, nW, heads, N, N
                                                ).reshape(Bn, heads, N, N)
            ins = tuple(x.detach().reshape(Bn, heads, N, 32)
                        .requires_grad_(True) for x in (qs, ks, vs))
            dout_lib = dos.reshape(Bn, heads, N, 32)
        o_lib = F.scaled_dot_product_attention(*ins, attn_mask=add,
                                               scale=32 ** -0.5)

        def lib():
            return torch.autograd.grad(o_lib, ins, dout_lib,
                                       retain_graph=True)

        libs[name] = {"ms": _time_ms(lib, iters=20),
                      "device_ms": _device_ms(lib, ""),
                      "kernel": _library_backend(lib)}
        del o_lib, add
    bound_ms, bound_by = _window_bwd_bound_ms(Bn, heads, N, 32)
    plan = wa.bwd_plan(Bn, N, heads, 1 if mask is None else nW)
    row = {"case": list(case), "shape": [Bn, N, heads, 32],
           "masked": mask is not None, "rel_err_dq_dk_dv": errs,
           "rel_err_dbias": db_err, "max_abs_err": abs_err,
           "bitwise_repeat": bitwise, "ms": ms,
           "device_ms": pass_ms + reduce_ms,
           "device_ms_pass_reduce": [pass_ms, reduce_ms],
           "launches_per_call_pass_reduce": [pass_n, reduce_n],
           "plain_ms": plain_ms, "library_ms": libs["grad_bias"]["ms"],
           "library_kernel": libs["grad_bias"]["kernel"],
           "library_bf16_mask_ms": libs["bf16_mask"]["ms"],
           "library_bf16_mask_kernel": libs["bf16_mask"]["kernel"],
           "library_device_ms": libs["grad_bias"]["device_ms"],
           "library_bf16_mask_device_ms": libs["bf16_mask"]["device_ms"],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": bound_ms / (pass_ms + reduce_ms),
           "plan": plan._asdict(), "smi_before_after": smi}
    _say("kernel check window_attention_bwd", json.dumps(row))
    return row


def _block_inputs(case, seed):
    """A bf16 (B, H, W, C) map, bf16 weights in nn.Linear layout of std
    1/sqrt(fan in), fp32 LN weights and the fp32 bias, on the card."""
    import torch
    B, H, W, C, w, shift = case
    gen = torch.Generator(device="cuda").manual_seed(3000 + seed)

    def rnd(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(dtype)

    lin = lambda o, i: (rnd(o, i, scale=i ** -0.5), rnd(o, scale=0.1))
    ln = lambda: (1 + rnd(C, scale=0.1, dtype=torch.float32),
                  rnd(C, scale=0.1, dtype=torch.float32))
    return dict(x=rnd(B, H, W, C), qkv=lin(3 * C, C), proj=lin(C, C),
                fc1=lin(4 * C, C), fc2=lin(C, 4 * C), ln1=ln(), ln2=ln(),
                bias=rnd(C // 32, w * w, w * w, scale=0.5,
                         dtype=torch.float32),
                mask=_swin_mask(case, "cuda"))


def _block_bound_ms(case, full):
    """Operations of the block's products and attention; bytes of the map
    read once and written once plus the weights (bf16) and the fp32 bias
    and mask tables."""
    from vit_torch_tpu_torch.ops.window_block import block_flops
    B, H, W, C, w, shift = case
    T, N = B * H * W, w * w
    nbytes = (2 * T * C * 2 + (12 if full else 4) * C * C * 2
              + (C // 32) * N * N * 4
              + (shift > 0) * (H // w) * (W // w) * N * N * 4)
    return _bound(block_flops(T, C, N, full), nbytes)


# the launches of one B8 and one B9 chain, in order
B8_LAUNCHES = ("qkv", "core", "proj")
B9_LAUNCHES = ("ln1", "qkv", "core", "proj", "ln2", "fc1", "fc2")


def check_window_blocks(case, seed):
    """B8 (``window_block_spatial``, row 8) and B9
    (``window_block_full_spatial``, row 9) vs their plain versions on one
    block case, the shift folded into the kernels' addressing and rolled by
    the plain versions; times each chain and each plain version, and reads
    each launch's own device time from one profiler pass over the chain.
    Then the window GEMM's products at this case (``check_window_gemm``,
    with B9's launch times)."""
    import torch
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift = case
    d = _block_inputs(case, seed)
    kw = dict(num_heads=C // 32, window=w, shift=shift)
    b8 = (d["x"], *d["qkv"], d["bias"], d["mask"], *d["proj"])
    b9 = (d["x"], d["ln1"], d["qkv"], d["bias"], d["mask"], d["proj"],
          d["ln2"], d["fc1"], d["fc2"])
    rows = {}
    for name, fn, ref_fn, args, full, launches in (
            ("window_block_spatial", wb.window_block_spatial,
             wb.window_block_spatial_reference, b8, False, B8_LAUNCHES),
            ("window_block_full_spatial", wb.window_block_full_spatial,
             wb.window_block_full_spatial_reference, b9, True,
             B9_LAUNCHES)):
        out = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = ref_fn(*args, **kw).float()
        abs_err = (out.float() - ref).abs().max().item()
        rel = abs_err / ref.abs().max().item()
        del ref
        if not (torch.isfinite(out).all() and rel <= BLOCK_RTOL):
            raise AssertionError(f"{name} {case}: max abs err relative to "
                                 f"max|plain| {rel} > {BLOCK_RTOL}")
        ms = _time_ms(lambda: fn(*args, **kw), iters=20)
        times = _launch_times(lambda: fn(*args, **kw), len(launches))
        device = [t for _, t in times]
        plain_ms = _time_ms(lambda: ref_fn(*args, **kw), iters=3)
        bound_ms, bound_by = _block_bound_ms(case, full)
        rows[name] = {"case": list(case), "max_abs_err": abs_err,
                      "max_rel_err": rel, "ms": ms,
                      "device_ms": (None if None in device
                                    else sum(device)),
                      "launch_device_ms": dict(zip(launches, device)),
                      "launch_kernels": [k for k, _ in times],
                      "plain_ms": plain_ms, "library_ms": None,
                      "bound_ms": bound_ms, "bound_by": bound_by}
        _say(f"kernel check {name}", json.dumps(rows[name]))
    rows["window_gemm"] = check_window_gemm(
        case, d, rows["window_block_full_spatial"]["launch_device_ms"])
    return rows


def _gemm_bound_ms(T, K, N, res):
    """2 T K N operations; A, W and Y (and the residual) once."""
    return _bound(2 * T * K * N,
                  (T * K + N * K + T * N * (2 if res else 1)) * 2)


def check_window_gemm(case, d, launch_ms):
    """B9's four window-GEMM launches at one block case, each launched
    alone with its real options (the gathered qkv, the scattered proj with
    its residual, fc1 with GELU, fc2 with its residual) and held against
    its plain composition (dense_f32 and the epilogue's roundings, the
    rows permuted as the kernel addresses them) within BLOCK_RTOL of max
    |plain| (one bf16 ulp of an output near 4 is 2^-6 of it: sums in
    another order can move a rounding by that); its device time from B9's
    profiler pass (``launch_ms``), TFLOP/s, bound and the bound's share;
    the library: cuBLAS F.linear at the same (T, K, N) over contiguous
    rows (events, device time, backend) and, for the gathered qkv and the
    scattered proj, index_select + F.linear."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import gemm as gm
    B, H, W, C, w, shift = case
    T, dev, bf16 = B * H * W, "cuda", torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(6000 + sum(case))
    order = ((torch.arange(B, device=dev) * H * W)[:, None]
             + gm.window_rows(H, W, w, shift, torch.device(dev))[None].long()
             ).view(-1)
    inverse = torch.argsort(order)
    geom = (H, W, w, shift)

    def r16(x):
        return x.to(bf16).float()

    products = []
    for name, K, N, epi, gather, scatter in (
            ("qkv", C, 3 * C, gm.EPI_BIAS, True, False),
            ("proj", C, C, gm.EPI_BIAS_RES, False, True),
            ("fc1", C, 4 * C, gm.EPI_GELU, False, False),
            ("fc2", 4 * C, C, gm.EPI_BIAS16_RES, False, False)):
        wt, bt = d[name]
        a = torch.randn((T, K), generator=gen, device=dev).to(bf16)
        res = (torch.randn((T, N), generator=gen, device=dev).to(bf16)
               if epi in (gm.EPI_BIAS_RES, gm.EPI_BIAS16_RES) else None)
        out = torch.empty((T, N), dtype=bf16, device=dev)

        def run():
            gm.gemm(a, wt, bt, out, epilogue=epi, geom=geom, gather=gather,
                    scatter=scatter, res=res)

        def plain():
            src = a[order] if gather else a
            acc = gm.dense_f32(src, wt, None)
            if epi == gm.EPI_BIAS:
                y = r16(acc + bt.float())
            elif epi == gm.EPI_BIAS_RES:
                y = r16(r16(acc + bt.float()) + res[order].float())
            elif epi == gm.EPI_GELU:
                y = r16(F.gelu(r16(r16(acc) + bt.float())))
            else:
                y = r16(res.float() + r16(r16(acc) + bt.float()))
            return y[inverse] if scatter else y

        run()
        torch.cuda.synchronize()
        ref = plain()
        err = (out.float() - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        if not (torch.isfinite(out).all() and rel <= BLOCK_RTOL):
            raise AssertionError(f"window_gemm {name} {case}: max abs err "
                                 f"relative to max|plain| {rel} > "
                                 f"{BLOCK_RTOL}")
        del ref
        plain_ms = _time_ms(plain, iters=3)

        def library():
            return F.linear(a, wt, bt)

        if gather:
            def permuted():
                return F.linear(a.index_select(0, order), wt, bt)
        elif scatter:
            def permuted():
                return F.linear(a, wt, bt).index_select(0, inverse)
        else:
            permuted = None
        ms = launch_ms.get(name)
        bound_ms, bound_by = _gemm_bound_ms(T, K, N, res is not None)
        flops = 2 * T * K * N
        library_device_ms = _device_ms(library, "")
        products.append({
            "launch": name, "T": T, "K": K, "N": N,
            "plan": gm.gemm_plan(T, K, N)._asdict(),
            "max_abs_err": err, "max_rel_err": rel, "device_ms": ms,
            "tflops": None if ms is None else flops / ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": None if ms is None else bound_ms / ms,
            "plain_ms": plain_ms, "library_ms": _time_ms(library, iters=20),
            "library_device_ms": library_device_ms,
            "library_tflops": flops / library_device_ms / 1e9,
            "library_backend": _library_backend(library),
            "index_select_linear_ms": (None if permuted is None
                                       else _time_ms(permuted, iters=20))})
        del a, res, out
    row = {"case": list(case), "products": products}
    _say("kernel check window_gemm", json.dumps(row))
    return row


def check_window_block_grads(case, seed):
    """The gradients of B8 and B9 through their autograd Functions (the
    kernel chains forward, B6 in the backward) vs autograd through their
    plain versions on one block case, every input but the mask; times one
    forward and backward of each."""
    import torch
    from vit_torch_tpu_torch.ops import window_attention as wa
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift = case
    d = _block_inputs(case, seed)
    kw = dict(num_heads=C // 32, window=w, shift=shift)
    gen = torch.Generator(device="cuda").manual_seed(5000 + seed)
    dout = torch.randn(d["x"].shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        d["x"], *d["ln1"], *d["qkv"], d["bias"], *d["proj"], *d["ln2"],
        *d["fc1"], *d["fc2"])]
    x, l1w, l1b, wq, bq, bias, wp, bp, l2w, l2b, w1, b1, w2, b2 = leaves
    rows = {}
    for name, fn, ref_fn, args, wrt in (
            ("window_block_spatial", wb.window_block_spatial,
             wb.window_block_spatial_reference,
             (x, wq, bq, bias, d["mask"], wp, bp),
             [x, wq, bq, bias, wp, bp]),
            ("window_block_full_spatial", wb.window_block_full_spatial,
             wb.window_block_full_spatial_reference,
             (x, (l1w, l1b), (wq, bq), bias, d["mask"], (wp, bp),
              (l2w, l2b), (w1, b1), (w2, b2)), leaves)):
        before = wa.window_attention_bwd.launches
        got = torch.autograd.grad(fn(*args, **kw), wrt, dout)
        torch.cuda.synchronize()
        if wa.window_attention_bwd.launches != before + 1:
            raise AssertionError(f"{name} grad did not launch B6 once")
        want = torch.autograd.grad(ref_fn(*args, **kw), wrt, dout)
        rel = [((g.float() - r.float()).abs().max()
                / r.float().abs().max().clamp_min(1e-30)).item()
               for g, r in zip(got, want)]
        finite = all(torch.isfinite(g).all().item() for g in got)
        del got, want
        if not (finite and max(rel) <= BLOCK_GRAD_RTOL):
            raise AssertionError(f"{name} grads {case}: error relative to "
                                 f"max|plain| {rel} (limit "
                                 f"{BLOCK_GRAD_RTOL})")
        ms = _time_ms(lambda: torch.autograd.grad(fn(*args, **kw), wrt,
                                                  dout), iters=5)
        rows[name] = {"case": list(case), "grad_rel_err": rel,
                      "fwd_bwd_ms": ms}
        _say(f"grad check {name}", json.dumps(rows[name]))
    return rows


def _th_bound_ms(B, H, N, D):
    return _bound(4 * B * H * N * N * D       # QK^T and PV
                  + 4 * B * H * H * N * N,    # the two (H, H) mixes
                  4 * B * H * N * D * 2)      # q, k, v read once, o written


def _th_library(q, k, v, tables, H, scale):
    """Row 11's form through one SDPA call: Q̂_g = q ⊙ (scale · wl[:, g]
    repeated over D), K̂ = k and V̂ = v shared by the H "heads" of width C
    (broadcast once, outside the timed call), then the ww mix as one einsum
    plus bw ⊙ colsum(V) (bl dropped: softmax is shift-invariant).
    ``(B, N, C)`` inputs; a callable."""
    import torch
    import torch.nn.functional as F
    wl, _, ww, bw = tables
    B, N, C = q.shape
    D = C // H
    wl_exp = (wl.t().repeat_interleave(D, dim=1) * scale)[None, :, None]
    ww_exp = ww.repeat_interleave(D, dim=1)
    bw_exp = bw.repeat_interleave(D)
    kh, vh = (x[:, None].expand(B, H, N, C).contiguous() for x in (k, v))

    def lib():
        qh = (q[:, None].float() * wl_exp).to(q.dtype)
        x = F.scaled_dot_product_attention(qh, kh, vh, scale=1.0)
        return (torch.einsum("bgnc,gc->bnc", x.float(), ww_exp)
                + bw_exp * v.float().sum(1, keepdim=True))

    return lib


def check_talking_heads(shape, seed, bnc: bool = False):
    """The talking-heads kernel (rows 10 and 11) vs its plain version on one
    shape: through ``talking_heads_attention_qkv`` as the model feeds it
    (q, k, v strided views into one (B, N, 3, H, D) qkv tensor), or through
    the (B, N, C) entry; mixing tables of std 0.3 around the identity,
    biases of std 0.1.  Times the kernel, the plain version and row 11's
    form through SDPA, names the kernel SDPA ran and checks that form
    against the plain version too.  ``ms`` is CUDA events over a loop of
    calls, ``device_ms`` the kernel's own time from one profiler pass (the
    two part where the host's launch rate sets the loop); the plan and the
    card's clocks and power around the timing beside them."""
    import torch
    from vit_torch_tpu_torch.ops import talking_heads as th
    B, H, N, D = shape
    gen = torch.Generator(device="cuda").manual_seed(6000 + seed)
    qkv = torch.randn((B, N, 3, H, D), generator=gen, device="cuda",
                      dtype=torch.bfloat16)
    eye = torch.eye(H, device="cuda")
    tables = (eye + 0.3 * torch.randn((H, H), generator=gen, device="cuda"),
              0.1 * torch.randn((H,), generator=gen, device="cuda"),
              eye + 0.3 * torch.randn((H, H), generator=gen, device="cuda"),
              0.1 * torch.randn((H,), generator=gen, device="cuda"))
    scale = D ** -0.5
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    qc, kc, vc = (x.reshape(B, N, H * D) for x in qkv.unbind(2))
    if bnc:
        def run():
            return th.talking_heads_attention_bnc(qc, kc, vc, *tables,
                                                  num_heads=H, scale=scale)
        out = run().view(B, N, H, D).transpose(1, 2)
    else:
        def run():
            return th.talking_heads_attention_qkv(qkv, *tables, scale=scale)
        out = run().transpose(1, 2)
    torch.cuda.synchronize()
    ref = th.talking_heads_reference(q, k, v, *tables, scale=scale).float()
    abs_err = (out.float() - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    if not (torch.isfinite(out).all() and rel <= TH_RTOL):
        raise AssertionError(f"talking_heads {shape}: max abs err relative "
                             f"to max|plain| {rel} > {TH_RTOL}")
    lib = _th_library(qc, kc, vc, tables, H, scale)
    lib_rel = ((lib().view(B, N, H, D).transpose(1, 2) - ref).abs().max()
               / ref.abs().max()).item()
    del ref
    big = B * H * N * N > 2e7
    smi = [_smi_sample()]
    ms = _time_ms(run, iters=20 if big else 100)
    (device_ms, launches), = _device_times(run, (TH_KERNELS,))
    by_launch = dict(zip(TH_LAUNCHES, (t for _, t in _launch_times(
        run, len(TH_LAUNCHES)))))
    smi.append(_smi_sample())
    plain_ms = _time_ms(lambda: th.talking_heads_reference(
        q, k, v, *tables, scale=scale), iters=3 if big else 20)
    library_ms = _time_ms(lib, iters=10 if big else 50)
    bound_ms, bound_by = _th_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "entry": "bnc" if bnc else "qkv",
           "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
           "device_ms": device_ms, "device_ms_by_launch": by_launch,
           "launches_per_call": launches,
           "plan": th.talking_heads_plan(
               B, H, N, D, sms=torch.cuda.get_device_properties(
                   0).multi_processor_count)._asdict(),
           "bound_share": _th_bound_ms(B, H, N, D)[0] / device_ms,
           "smi_before_after": smi,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_kernel": _library_backend(lib) if seed == 0 else None,
           "library_max_rel_err": lib_rel, "bound_ms": bound_ms,
           "bound_by": bound_by}
    _say("kernel check talking_heads", json.dumps(row))
    return row


def _show_layerscale(state) -> None:
    """Set every CaiT LayerScale gate of a state dict to CAIT_GAMMA."""
    for name, value in state.items():
        if ".gamma_" in name:
            value.fill_(CAIT_GAMMA)


def _plain_th_qkv(qkv, wl, bl, ww, bw, *, scale):
    """The CaiT block's attention call on the plain version (differentiable
    through autograd), patched in for the kernel-vs-plain comparisons."""
    from vit_torch_tpu_torch.ops import talking_heads as th
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    return th.talking_heads_reference(q, k, v, wl, bl, ww, bw,
                                      scale=scale).transpose(1, 2)


def _plain_talking_heads():
    from vit_torch_tpu_torch.ops import talking_heads as th
    return mock.patch.object(th, "talking_heads_attention_qkv", _plain_th_qkv)


def _plain_window_blocks():
    """The Swin blocks on their plain versions, patched in for the
    kernel-vs-plain comparison of the served model."""
    import contextlib
    from vit_torch_tpu_torch.ops import window_block as wb
    stack = contextlib.ExitStack()
    for name in ("window_block_spatial", "window_block_full_spatial"):
        stack.enter_context(mock.patch.object(
            wb, name, getattr(wb, f"{name}_reference")))
    return stack


def _plain_qkv(qkv, *, scale):
    """The model's attention call on the plain version (differentiable
    through autograd), patched in for the kernel-vs-plain comparisons."""
    from vit_torch_tpu_torch.ops import flash_attention as fa
    q, k, v = (x.transpose(1, 2) for x in qkv.unbind(2))
    return fa.flash_attention_bhnd_reference(q, k, v,
                                             scale=scale).transpose(1, 2)


def _png_b64(arr: np.ndarray) -> str:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _post(addr, payload, timeout=300):
    conn = http.client.HTTPConnection(*addr, timeout=timeout)
    try:
        conn.request("POST", "/v1/predict", body=json.dumps(payload))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _get(addr, path):
    conn = http.client.HTTPConnection(*addr, timeout=60)
    try:
        conn.request("GET", path)
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def _kernel_group(name: str) -> str:
    low = name.lower()
    if "flash_fwd_kernel" in name:
        return "flash_attention_fwd"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "window_attn_fwd_kernel" in name:
        return "window_attention"
    if "window_attn_bwd_kernel" in name or "dbias_reduce_kernel" in name:
        return "window_attention_bwd"
    if "window_gemm_kernel" in name:
        return "window_gemm"        # the B7 / B8 / B9 products
    if "attn_block_qkv_kernel" in name:
        return "attention_block_qkv"   # B3 / B4's qkv product
    if "attn_block_kernel" in name:
        return "attention_block"    # B3 / B4 attention and projection
    if any(k in name for k in TH_KERNELS):
        return "talking_heads"
    if "fused_mlp_kernel" in name:
        return "fused_mlp"
    if any(t in low for t in ("batch_norm", "batchnorm", "bn_fw", "bn_bw",
                              "bn_bwd", "bn_fwd")):
        return "batch_norm"         # cuDNN's and PyTorch's BN, train and eval
    if any(t in low for t in ("fprop", "dgrad", "wgrad", "conv2d",
                              "convolve", "convolution", "depthwise", "pool",
                              "nhwc", "cudnn")):
        # cuDNN convs, their slices and layout moves, pooling (cuDNN runs
        # some 1x1 convs as nvjet GEMMs, which fall under "matmul")
        return "conv"
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    if "layer_norm" in low or "gammabetabackward" in low:
        return "layer_norm"
    if "multi_tensor_apply" in low or "adam" in low:
        return "optimizer"
    if "reduce_kernel" in low:
        return "reduce"             # bias gradients, loss and metric sums
    if "copy" in low:
        return "copy_cast"          # dtype casts, H2D/D2H
    return "other"


def _device_groups(prof, iters: int, window_ms: float, top_n: int):
    """Device time per call by kernel group, the busiest kernels, and the
    device's idle share of the host-clock window.  GPU-side user
    annotations (``Optimizer.step#...``) span kernels counted on their own
    and are left out."""
    import torch
    groups, top = {}, []
    for ev in prof.key_averages():
        if (ev.device_type != torch.autograd.DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        ms = ev.self_device_time_total / 1e3 / iters
        group = _kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, ev.count // iters, ev.key[:90]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {"window_ms": window_ms, "device_busy_ms": busy,
            "idle_share": 1 - busy / window_ms if busy else None,
            "groups_ms": groups, "top_kernels_ms_calls": top[:top_n]}


def profile_predict(model, batch, iters: int = 3):
    """Device time of ``ServingModel.predict`` by kernel group, and the
    device's idle share of the host-clock window, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    model.predict(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            model.predict(batch)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0) / iters
    return {"bucket": len(batch),
            **_device_groups(prof, iters, window_ms, top_n=8)}


def _depth(backbone) -> int:
    if hasattr(backbone, "blocks"):
        return len(backbone.blocks)
    return sum(len(layer.blocks) for layer in backbone.layers)


def serve_end_to_end(workdir: str, arch: str, image_size: int,
                     kernels, plain, flops_per_image: int,
                     logits_tol: float, relative: bool, prepare=None,
                     buckets: str = BUCKETS, per_dispatch=None):
    """Export → BundleServer on cuda → concurrent HTTP requests; prints
    the serving numbers and returns the launch counts of the HTTP run.
    Each of ``kernels`` must launch once per layer (``per_dispatch`` times
    when given) per dispatch, and no other kernel at all.  ``plain()`` is
    a context that patches the plain versions in; the logits of the two
    must agree within ``logits_tol`` (relative to max |plain logit| when
    ``relative``); with ``plain=None`` the served logits are held against
    an fp32 forward of the bundle's weights on the CPU instead.
    ``prepare(state)`` may edit the exported state dict in place before
    the server loads it.  The last of ``buckets`` is the batch of the
    batched request and of the served img/s."""
    import torch
    from vit_torch_tpu_torch.cli import export as cli_export
    from vit_torch_tpu_torch.data.datasets import resize_images
    from vit_torch_tpu_torch.serving.server import BundleServer

    bundle = f"{workdir}/bundle-{arch}"
    t0 = time.perf_counter()
    cli_export.main(["--arch", arch, "--classifier", CLASSIFIER,
                     "--image_size", str(image_size), "--bs", buckets,
                     "--dataset", "stl10", "--out", bundle])
    _say(f"export {arch} seconds {time.perf_counter() - t0:.2f}")
    if prepare is not None:
        weights = f"{bundle}/weights.pt"
        state = torch.load(weights, weights_only=True)
        prepare(state)
        torch.save(state, weights)

    server = BundleServer(bundle, port=0, max_wait_ms=10)
    try:
        depth = per_dispatch or _depth(server.model.model.backbone)
        addr = server.address
        server.start()
        rng = np.random.default_rng(0)
        sizes = tuple(int(b) for b in buckets.split(","))
        big = sizes[-1]
        batch = rng.integers(0, 256, (big, image_size, image_size, 3),
                             dtype=np.uint8)
        for bs in sizes:                        # warm cuBLAS per bucket
            server.model.predict(batch[:bs])

        sides = (96, 160, 224, 256, 300, 517)
        singles = [rng.integers(0, 256, (s, s + 13 * (i % 3), 3),
                                dtype=np.uint8)
                   for i, s in enumerate(sides * 4)]
        payloads = ([{"images": [_png_b64(img)]} for img in singles]
                    + [{"images": [_png_b64(img) for img in batch]}])
        replies = [None] * len(payloads)

        def send(i):
            replies[i] = _post(addr, payloads[i])

        threads = [threading.Thread(target=send, args=(i,))
                   for i in range(len(payloads))]
        _reset_counts()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_s = time.perf_counter() - t0
        launches = _read_counts()
        if any(t.is_alive() for t in threads):
            raise AssertionError("an HTTP request did not finish")
        status, stats = _get(addr, "/stats")
        if status != 200:
            raise AssertionError(f"/stats answered {status}")
        dispatches = sum(stats["dispatches"].values())
        _say(f"http {arch} requests {len(payloads)} images "
             f"{len(singles) + len(batch)} seconds {http_s:.3f} "
             f"dispatches {stats['dispatches']} launches {launches}")
        want = _want(**{k: depth * dispatches for k in kernels})
        if launches != want or dispatches == 0:
            raise AssertionError(f"{arch} launches {launches} != {want} "
                                 f"({depth} layers x {dispatches} "
                                 f"dispatches)")
        for status, body in replies:
            if status != 200:
                raise AssertionError(f"predict answered {status}: {body}")
            for pred in body["predictions"]:
                logits = np.asarray(pred["logits"])
                if logits.shape != (10,) or not np.isfinite(logits).all():
                    raise AssertionError(f"bad logits {logits}")
                if pred["label"] != int(np.argmax(logits)):
                    raise AssertionError("label is not the argmax")
        http_big = np.asarray([p["logits"]
                               for p in replies[-1][1]["predictions"]])

        # logits: kernel path vs plain versions, same weights, on the card
        # (or vs the CPU in fp32)
        resized = resize_images(batch, image_size)
        kernel_logits = server.model.predict(resized)
        if plain is None:
            plain_logits = _cpu_fp32_logits(bundle, resized)
        else:
            with plain():
                plain_logits = server.model.predict(resized)
        err = float(np.abs(kernel_logits - plain_logits).max())
        err_http = float(np.abs(http_big - plain_logits).max())
        max_logit = float(np.abs(plain_logits).max())
        versus = "cpu fp32" if plain is None else "plain"
        _say(f"logits {arch} card vs {versus}: max abs err {err:.5f} "
             f"(http {err_http:.5f}), max |logit| {max_logit:.4f}, argmax "
             f"agree "
             f"{int((kernel_logits.argmax(1) == plain_logits.argmax(1)).sum())}"
             f"/{big}")
        limit = logits_tol * (max_logit if relative else 1.0)
        if not max(err, err_http) <= limit:
            raise AssertionError(f"served logits differ from the plain "
                                 f"versions by {max(err, err_http)} > "
                                 f"{limit}")

        # predict time per bucket, uint8 in, logits out, host clock; the
        # largest bucket gives the served img/s
        predict_ms = {}
        for bs in sizes:
            t0 = time.perf_counter()
            for _ in range(20):
                server.model.predict(batch[:bs])
            predict_ms[bs] = 1e3 * (time.perf_counter() - t0) / 20
        x = torch.from_numpy(batch).to(server.model.device)
        with torch.inference_mode():
            fwd_ms = _time_ms(lambda: server.model.model(
                (x.to(server.model.mean.dtype) / 255.0 - server.model.mean)
                / server.model.std), iters=10)
        _say(json.dumps({
            "serve": {"arch": arch, "image_size": image_size, "depth": depth,
                      "bucket": big,
                      "predict_img_per_s": big * 1e3 / predict_ms[big],
                      "predict_ms_by_bucket": predict_ms,
                      "forward_ms_cuda_events": fwd_ms,
                      "forward_img_per_s": big * 1e3 / fwd_ms,
                      "forward_tflop_per_s": big * flops_per_image / fwd_ms
                      / 1e9,
                      "stats": stats, "logits_max_abs_err": err,
                      "max_abs_logit": max_logit}}))
        _say(json.dumps({"profile": profile_predict(server.model, batch)}))
        return launches
    finally:
        server.shutdown()


def _cpu_fp32_logits(bundle: str, images: np.ndarray) -> np.ndarray:
    """The bundle's classifier in fp32 on the CPU (its weights and BN
    statistics, eval mode), normalising uint8 images as the bundle does."""
    import torch
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    with open(f"{bundle}/manifest.json") as f:
        manifest = json.load(f)
    zm = VisionModelZoo.get_model(
        manifest["arch"], classifier=manifest["classifier"],
        image_size=manifest["image_size"], dtype=torch.float32, device="cpu")
    zm.model.load_state_dict(torch.load(f"{bundle}/weights.pt",
                                        weights_only=True))
    mean, std = (torch.tensor(manifest["norm"][k]) for k in ("mean", "std"))
    with torch.inference_mode():
        x = (torch.from_numpy(images).float() / 255.0 - mean) / std
        return zm.model.eval()(x).numpy()


def _show_conv_state(state) -> None:
    """Raise XCiT's LayerScale gates to CONV_GAMMA and draw every BN's
    running statistics (seeded) away from their init, in a state dict."""
    import torch
    gen = torch.Generator().manual_seed(7)
    for name, value in state.items():
        if ".gamma" in name:
            value.fill_(CONV_GAMMA)
        elif name.endswith("running_mean"):
            value.copy_(0.1 * torch.randn(value.shape, generator=gen))
        elif name.endswith("running_var"):
            value.copy_(0.5 + torch.rand(value.shape, generator=gen))


def _plain_attention():
    from vit_torch_tpu_torch.ops import attention as attention_mod
    return mock.patch.object(attention_mod, "flash_attention_qkv", _plain_qkv)


def _counters():
    """Every kernel wrapper, by the name it has in the kernels line."""
    from vit_torch_tpu_torch.ops import attn_block as ab
    from vit_torch_tpu_torch.ops import flash_attention as fa
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    from vit_torch_tpu_torch.ops import gemm as gm
    from vit_torch_tpu_torch.ops import talking_heads as th
    from vit_torch_tpu_torch.ops import window_attention as wa
    from vit_torch_tpu_torch.ops import window_block as wb
    return {"flash_attention_fwd": fa.flash_attention_bhnd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "window_attention": wa.window_attention,
            "window_attention_bwd": wa.window_attention_bwd,
            "window_block_spatial": wb.window_block_spatial,
            "window_block_full_spatial": wb.window_block_full_spatial,
            "talking_heads": th.talking_heads_attention,
            "attention_block": ab.attention_block,
            "attention_block_packed": ab.attention_block_packed,
            "fused_mlp": fm.fused_mlp,
            "window_block": wb.window_block,
            "window_gemm": gm.gemm}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _want(**launches):
    """Launch counts with every kernel not named at 0; the window GEMM's,
    unless named, those of the window blocks' chains: 2 products in B7
    and B8, 4 in B9."""
    launches.setdefault("window_gemm", 2 * launches.get("window_block", 0)
                        + 2 * launches.get("window_block_spatial", 0)
                        + 4 * launches.get("window_block_full_spatial", 0))
    return {name: launches.get(name, 0) for name in _counters()}


def _run_cli(main_fn, argv, fp: str, mode: str, want,
             samples: int = SYNTHETIC_N):
    """One epoch of the synthetic data (``samples`` of each split) through
    a port CLI on the card; checks the stats JSON and the kernels' launch
    counts."""
    _reset_counts()
    t0 = time.perf_counter()
    main_fn(argv + ["--stats_fp", fp])
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    with open(fp) as f:
        stats = json.load(f)
    rows = {split: stats[split] for split in ("train", "val")}
    _say(json.dumps({"cli": {"mode": mode, "seconds": seconds,
                             "launches": counts, "want": want,
                             "telem": stats["telem"],
                             "results": stats["results"]}}))
    if counts != want:
        raise AssertionError(f"{mode}: kernel launches {counts} != {want}")
    for split, r in rows.items():
        if len(r) != 1 or not all(np.isfinite(x["loss"]) for x in r):
            raise AssertionError(f"{mode}: bad {split} rows {r}")
        if r[0]["sample"] != samples:
            raise AssertionError(f"{mode}: {split} saw {r[0]['sample']} "
                                 f"samples, not {samples}")
    return counts


def train_through_cli(workdir: str, lineareval: bool):
    """dino_vitb8 fine-tune, or cached linear eval, through ``cli.main``."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    mode = "lineareval" if lineareval else "finetune"
    depth = VIT_CONFIGS[ARCH].depth
    steps = SYNTHETIC_N // TRAIN_BS           # per split
    if lineareval:
        # the frozen backbone runs once over each split (forward only);
        # the head trains on cached features
        want = _want(flash_attention_fwd=depth * 2 * steps)
    else:
        want = _want(flash_attention_fwd=depth * 2 * steps,
                     flash_attention_bwd=depth * steps)
    return _run_cli(cli_main.main, TRAIN_ARGS + (
        ["--lineareval", "--cache_features"] if lineareval else []),
        f"{workdir}/{mode}.json", mode, want)


def swin_lineareval_through_cli(workdir: str, cached: bool):
    """swin_base_384 linear eval (bench config 4's unit) through
    ``cli.main_swin``.  In a train step the backbone runs in train mode
    under no_grad: block 0's drop-path rate is 0, so it takes B9, and the
    23 blocks whose drop-path is active take B8; every eval step takes B9
    in all 24 blocks.  The cached run takes B9 only, once over each
    split."""
    from vit_torch_tpu_torch.cli import main_swin
    steps = SYNTHETIC_N // TRAIN_BS
    if cached:
        want = _want(window_attention=SWIN_DEPTH * 2 * steps,
                     window_block_full_spatial=SWIN_DEPTH * 2 * steps)
    else:
        want = _want(window_attention=SWIN_DEPTH * 2 * steps,
                     window_block_spatial=(SWIN_DEPTH - 1) * steps,
                     window_block_full_spatial=(1 + SWIN_DEPTH) * steps)
    mode = "swin_lineareval" + ("_cached" if cached else "")
    return _run_cli(main_swin.main, SWIN_TRAIN_ARGS + ["--lineareval"] + (
        ["--cache_features"] if cached else []), f"{workdir}/{mode}.json",
        mode, want)


def _plain_attention_calls():
    from vit_torch_tpu_torch.ops import window_attention as wa
    return (wa.window_attention_reference, wa.window_attention_bwd_reference)


def swin_finetune_through_cli(workdir: str):
    """swin_base_384 fine-tune through ``cli.main_swin`` without
    ``--lineareval``: in a train step block 0 (drop-path rate 0) takes B9
    with grad and the 23 others B8 with grad; every block's attention
    backward is one B6 launch, and B9's backward recomputes its core once
    (one more core launch a step); eval steps take B9 in all 24 blocks.
    The plain window attention, forward or backward, never runs."""
    from vit_torch_tpu_torch.cli import main_swin
    steps = SYNTHETIC_N // TRAIN_BS
    want = _want(window_attention=(2 * SWIN_DEPTH + 1) * steps,
                 window_attention_bwd=SWIN_DEPTH * steps,
                 window_block_spatial=(SWIN_DEPTH - 1) * steps,
                 window_block_full_spatial=(1 + SWIN_DEPTH) * steps)
    for fn in _plain_attention_calls():
        fn.calls = 0
    counts = _run_cli(main_swin.main, SWIN_FINETUNE_ARGS,
                      f"{workdir}/swin_finetune.json", "swin_finetune", want)
    plain = [fn.calls for fn in _plain_attention_calls()]
    if any(plain):
        raise AssertionError(f"the fine-tune ran the plain window attention "
                             f"forward and backward {plain} times")
    return counts


def cait_through_cli(workdir: str, mode: str):
    """cait_s24_224 through ``cli.main``: ``lineareval`` (the backbone in
    train mode under no_grad in train steps), ``lineareval_cached`` (the
    backbone once over each split) or ``finetune``.  Every backbone forward
    launches the talking-heads kernel once per block, train and eval steps
    alike; no plain talking-heads forward runs; the fine-tune's backward
    recomputes each block once through the plain version."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.ops import talking_heads as th
    steps = SYNTHETIC_N // TRAIN_BS
    extra = {"lineareval": ["--lineareval"],
             "lineareval_cached": ["--lineareval", "--cache_features"],
             "finetune": []}[mode]
    th.talking_heads_reference.calls = th.talking_heads_bwd.calls = 0
    counts = _run_cli(cli_main.main, CAIT_TRAIN_ARGS + extra,
                      f"{workdir}/cait_{mode}.json", f"cait_{mode}",
                      _want(talking_heads=CAIT_DEPTH * 2 * steps))
    plain, recomputes = (th.talking_heads_reference.calls,
                         th.talking_heads_bwd.calls)
    want = CAIT_DEPTH * steps if mode == "finetune" else 0
    _say(f"cait_{mode}: plain talking-heads forwards {plain}, backward "
         f"recomputes {recomputes}")
    if plain or recomputes != want:
        raise AssertionError(f"cait_{mode}: {plain} plain forwards (want 0), "
                             f"{recomputes} backward recomputes (want "
                             f"{want})")
    return dict(counts, backward_recomputes=recomputes)


def _train_setup(bs: int, seed: int = 0, arch: str = ARCH,
                 image_size: int = IMAGE_SIZE, lineareval: bool = False,
                 lr: float = 1e-4):
    """A seeded full-width trainer (finetune, or linear eval) and one uint8
    batch on the card."""
    import torch
    from vit_torch_tpu_torch.data.augment import (make_eval_transform,
                                                  make_train_augment)
    from vit_torch_tpu_torch.data.datasets import (NORM_VALUES,
                                                   _synthetic_arrays)
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.trainer import Trainer
    zm = VisionModelZoo.get_model(
        arch, classifier=[512, 10], image_size=image_size,
        generator=torch.Generator().manual_seed(seed))
    norm = NORM_VALUES["synthetic"]
    trainer = Trainer(zm, opt="adamw", lr=lr, seed=seed,
                      lineareval=lineareval,
                      augment_fn=make_train_augment(**norm,
                                                    dtype=torch.bfloat16),
                      eval_transform=make_eval_transform(
                          **norm, dtype=torch.bfloat16),
                      print_progress=False)
    imgs, labels = _synthetic_arrays("train", n=bs, image_size=image_size,
                                     seed=seed)
    batch = (torch.from_numpy(imgs).cuda(),
             torch.from_numpy(labels.astype(np.int64)).cuda(),
             torch.ones(bs, device="cuda"))
    return zm, trainer, batch


def _profile_calls(fn, iters: int = 2):
    """Device time of ``fn`` by kernel group and the device's idle share
    of the host-clock window, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0) / iters
    return _device_groups(prof, iters, window_ms, top_n=10)


def profile_train_step(trainer, batch, iters: int = 2):
    """Device time of the train step by kernel group and the device's idle
    share of the host-clock window, from torch.profiler."""
    return _profile_calls(lambda: trainer.train_step(*batch), iters)


def _time_train_steps(trainer, batch, iters: int):
    """Warm-up, the launches of one step, then ``iters`` steps on CUDA
    events and the host clock, the peak memory allocated and a profile of
    two more steps; ``steps_run`` counts every step taken."""
    import torch
    for _ in range(3):
        trainer.train_step(*batch)
    torch.cuda.synchronize()
    _reset_counts()
    trainer.train_step(*batch)
    per_step = _read_counts()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        trainer.train_step(*batch)
    end.record()
    torch.cuda.synchronize()
    return {"iters": iters, "step_ms": start.elapsed_time(end) / iters,
            "host_step_ms": 1e3 * (time.perf_counter() - t0) / iters,
            "launches_per_step": per_step,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "profile": profile_train_step(trainer, batch, iters=2),
            "steps_run": 3 + 1 + iters + 2}


def steady_state_train(iters: int = 12):
    """The finetune step at bs32 (augment, forward, loss, backward, AdamW)
    on the card: CUDA-event time over ``iters`` steps after warm-up, MFU
    against the dense bf16 peak, a profile, and the launches per step."""
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    zm, trainer, batch = _train_setup(TRAIN_BS)
    zm.model.train()
    t = _time_train_steps(trainer, batch, iters)
    step_ms, per_step = t["step_ms"], t["launches_per_step"]
    step_flops = 3 * vit_flops(VIT_CONFIGS[ARCH], IMAGE_SIZE) * TRAIN_BS
    row = {"arch": ARCH, "image_size": IMAGE_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "train_step_ms": step_ms,
           "host_step_ms": t["host_step_ms"],
           "train_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step, "peak_mem_gb": t["peak_mem_gb"],
           "profile": t["profile"]}
    _say(json.dumps({"train": row}))
    depth = VIT_CONFIGS[ARCH].depth
    if per_step != _want(flash_attention_fwd=depth,
                         flash_attention_bwd=depth):
        raise AssertionError(f"launches per train step {per_step}")
    return row


def steady_state_swin_lineareval(iters: int = 12):
    """The swin_base_384 linear-eval step at bs32 (augment, backbone in
    train mode under no_grad on the B8 route, head forward and backward,
    AdamW on the head) on the card: CUDA-event time over ``iters`` steps
    after warm-up, MFU with step FLOPs = 1 x forward (the backbone runs no
    backward; ``bench.py`` counts the same), a profile, the launches per
    step; and a bs32 eval forward (the B9 route) timed on its own."""
    import torch
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, swin_flops
    zm, trainer, batch = _train_setup(TRAIN_BS, arch=SWIN_ARCH,
                                      image_size=SWIN_SIZE, lineareval=True,
                                      lr=1e-3)
    zm.model.train()
    smi = [_smi_sample()]
    t = _time_train_steps(trainer, batch, iters)
    smi.append(_smi_sample())
    step_ms, per_step = t["step_ms"], t["launches_per_step"]
    fwd_flops = swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    zm.model.eval()
    x = trainer.eval_transform(batch[0])
    _reset_counts()
    with torch.no_grad():
        eval_ms = _time_ms(lambda: zm.model(x), iters=10)
        smi.append(_smi_sample())
        eval_counts = _read_counts()
        eval_profile = _profile_calls(lambda: zm.model(x), iters=3)
    row = {"arch": SWIN_ARCH, "image_size": SWIN_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "lineareval_step_ms": step_ms,
           "host_step_ms": t["host_step_ms"],
           "lineareval_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": fwd_flops / 1e12,
           "mfu": fwd_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step, "peak_mem_gb": t["peak_mem_gb"],
           "eval_forward_ms": eval_ms,
           "eval_forward_img_per_s": TRAIN_BS * 1e3 / eval_ms,
           "eval_forward_mfu": fwd_flops / (eval_ms / 1e3) / H100_BF16_FLOPS,
           "eval_forward_profile": eval_profile,
           "smi_before_after_step_after_eval": smi,
           "profile": t["profile"]}
    _say(json.dumps({"swin_lineareval_step": row}))
    if per_step != _want(window_attention=SWIN_DEPTH,
                         window_block_spatial=SWIN_DEPTH - 1,
                         window_block_full_spatial=1):
        raise AssertionError(f"launches per lineareval step {per_step}")
    if eval_counts != _want(window_attention=SWIN_DEPTH * 12,
                            window_block_full_spatial=SWIN_DEPTH * 12):
        raise AssertionError(f"launches in 12 eval forwards {eval_counts}")
    return row


def compare_step_with_plain(bs: int = 8, arch: str = ARCH,
                            image_size: int = IMAGE_SIZE, env=None,
                            plain=_plain_attention, want=None,
                            name: str = "step_vs_plain"):
    """Loss and gradients of one bs8 finetune step (dropout-free model,
    eval-normalised batch, no optimizer step) on the kernel path and on
    the plain versions (``plain()`` patches them in), same weights and
    batch, under the environment ``env``; the kernel step's launches must
    be ``want`` when given."""
    import torch
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    zm, trainer, (images, labels, mask) = _train_setup(
        bs, seed=1, arch=arch, image_size=image_size)
    model = zm.model
    model.train()
    x = trainer.eval_transform(images)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(x), labels, mask)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    with mock.patch.dict(os.environ, env or {}):
        _reset_counts()
        loss_k, grads_k = loss_and_grads()
        counts = _read_counts()
        with plain():
            loss_p, grads_p = loss_and_grads()
    if _read_counts() != counts:
        raise AssertionError("the plain step launched a kernel")
    if want is not None and counts != want:
        raise AssertionError(f"{name}: launches in the kernel step {counts} "
                             f"!= {want}")
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    row = {"arch": arch, "image_size": image_size, "env": env or {},
           "bs": bs, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_abs_diff": abs(loss_k - loss_p),
           "max_grad_rel_err": rel[worst], "worst_param": worst,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "launches": counts}
    _say(json.dumps({name: row}))
    if not (np.isfinite(loss_k) and row["loss_abs_diff"] <= STEP_LOSS_ATOL
            and rel[worst] <= STEP_GRAD_RTOL):
        raise AssertionError(f"{name}: kernel step vs plain step: {row} "
                             f"(limits loss {STEP_LOSS_ATOL}, grad "
                             f"{STEP_GRAD_RTOL})")
    return row


def steady_state_swin_finetune(iters: int = 12):
    """The swin_base_384 fine-tune step at bs32 (augment, forward with
    grad, loss, backward through B6, AdamW on every parameter) on the
    card: CUDA-event time over ``iters`` steps after warm-up, MFU with
    step FLOPs = 3 x forward (``bench.py``'s count), a profile by kernel
    group with the idle share, the launches per step and the peak memory
    allocated."""
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, swin_flops
    zm, trainer, batch = _train_setup(TRAIN_BS, arch=SWIN_ARCH,
                                      image_size=SWIN_SIZE, lr=1e-4)
    zm.model.train()
    smi = [_smi_sample()]
    t = _time_train_steps(trainer, batch, iters)
    smi.append(_smi_sample())
    step_ms, per_step = t["step_ms"], t["launches_per_step"]
    step_flops = 3 * swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    row = {"arch": SWIN_ARCH, "image_size": SWIN_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "finetune_step_ms": step_ms,
           "host_step_ms": t["host_step_ms"],
           "finetune_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step, "peak_mem_gb": t["peak_mem_gb"],
           "smi_before_after": smi, "profile": t["profile"]}
    _say(json.dumps({"swin_finetune_step": row}))
    if per_step != _want(window_attention=SWIN_DEPTH + 1,
                         window_attention_bwd=SWIN_DEPTH,
                         window_block_spatial=SWIN_DEPTH - 1,
                         window_block_full_spatial=1):
        raise AssertionError(f"launches per finetune step {per_step}")
    return row


def compare_swin_step_with_plain(bs: int = 8):
    """Loss and gradients of one bs8 swin_base_384 fine-tune step
    (eval-normalised batch, no optimizer step) on the kernels and on the
    plain versions of B8 and B9 (autograd through them, no kernel), same
    weights, batch and drop-path masks; the limits are the dino step's
    (STEP_LOSS_ATOL, STEP_GRAD_RTOL), here over 24 blocks."""
    import torch
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    zm, trainer, (images, labels, mask) = _train_setup(
        bs, seed=1, arch=SWIN_ARCH, image_size=SWIN_SIZE)
    model = zm.model
    model.train()
    x = trainer.eval_transform(images)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        trainer.generator.manual_seed(7)          # the same drop-path masks
        loss = cross_entropy_loss(model(x), labels, mask)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    _reset_counts()
    loss_k, grads_k = loss_and_grads()
    counts = _read_counts()
    with _plain_window_blocks():
        loss_p, grads_p = loss_and_grads()
    if _read_counts() != counts:
        raise AssertionError("the plain step launched a kernel")
    if counts != _want(window_attention=SWIN_DEPTH + 1,
                       window_attention_bwd=SWIN_DEPTH,
                       window_block_spatial=SWIN_DEPTH - 1,
                       window_block_full_spatial=1):
        raise AssertionError(f"launches in the kernel step {counts}")
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    tables = [v for n, v in rel.items() if "relative_position" in n]
    row = {"arch": SWIN_ARCH, "bs": bs, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
           "max_grad_rel_err": rel[worst], "worst_param": worst,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "max_bias_table_grad_rel_err": max(tables), "launches": counts}
    _say(json.dumps({"swin_step_vs_plain": row}))
    if not (np.isfinite(loss_k) and row["loss_abs_diff"] <= STEP_LOSS_ATOL
            and rel[worst] <= STEP_GRAD_RTOL):
        raise AssertionError(f"swin kernel step vs plain step: {row} "
                             f"(limits loss {STEP_LOSS_ATOL}, grad "
                             f"{STEP_GRAD_RTOL})")
    return row


def steady_state_cait(iters: int = 12):
    """cait_s24_224 at bs32 on the card: the fine-tune step (MFU with 3 x
    forward FLOPs, ``cait_flops``), the linear-eval step (1 x forward) and
    a bs32 eval forward, each on CUDA events after warm-up, with the
    launches per step, the peak memory and a profile of each step."""
    import torch
    from vit_torch_tpu_torch.models.cait import CAIT_CONFIGS, cait_flops
    from vit_torch_tpu_torch.ops import talking_heads as th
    fwd_flops = cait_flops(CAIT_CONFIGS[CAIT_ARCH], CAIT_SIZE) * TRAIN_BS
    rows = {}
    for mode, flops in (("finetune", 3 * fwd_flops),
                        ("lineareval", fwd_flops)):
        zm, trainer, batch = _train_setup(TRAIN_BS, arch=CAIT_ARCH,
                                          image_size=CAIT_SIZE,
                                          lineareval=mode == "lineareval")
        zm.model.train()
        recomputes = th.talking_heads_bwd.calls
        row = _time_train_steps(trainer, batch, iters)
        recomputes = th.talking_heads_bwd.calls - recomputes
        row.update(mode=mode, img_per_s=TRAIN_BS * 1e3 / row["step_ms"],
                   step_tflop=flops / 1e12,
                   mfu=flops / (row["step_ms"] / 1e3) / H100_BF16_FLOPS)
        rows[mode] = row
        if row["launches_per_step"] != _want(talking_heads=CAIT_DEPTH):
            raise AssertionError(f"cait {mode}: launches per step "
                                 f"{row['launches_per_step']}")
        want = CAIT_DEPTH * row["steps_run"] if mode == "finetune" else 0
        if recomputes != want:
            raise AssertionError(f"cait {mode}: {recomputes} backward "
                                 f"recomputes, want {want}")
        if mode == "lineareval":
            zm.model.eval()
            x = trainer.eval_transform(batch[0])
            _reset_counts()
            with torch.no_grad():
                eval_ms = _time_ms(lambda: zm.model(x), iters=10)
            counts = _read_counts()
            if counts != _want(talking_heads=CAIT_DEPTH * 12):
                raise AssertionError(f"cait: launches in 12 eval forwards "
                                     f"{counts}")
            rows["eval_forward"] = {
                "ms": eval_ms, "img_per_s": TRAIN_BS * 1e3 / eval_ms,
                "mfu": fwd_flops / (eval_ms / 1e3) / H100_BF16_FLOPS}
        del zm, trainer, batch
        torch.cuda.empty_cache()
    _say(json.dumps({"cait_steady_state": {
        "arch": CAIT_ARCH, "image_size": CAIT_SIZE, "bs": TRAIN_BS,
        "opt": "adamw", **rows}}))
    return rows


def compare_cait_step_with_plain(bs: int = 8):
    """Loss and gradients of one bs8 cait_s24_224 fine-tune step
    (eval-normalised batch, no optimizer step) with the talking-heads
    kernel forward and with the plain version (autograd through it, no
    kernel), same weights (LayerScale gates at CAIT_GAMMA) and batch; the
    limits are the dino step's (STEP_LOSS_ATOL, STEP_GRAD_RTOL), here over
    24 blocks.  ``proj_l.bias`` and the class attention's ``k.bias`` shift
    whole softmax rows, so their gradients are 0 in exact arithmetic and
    rounding noise on both sides: their norms are reported, not held to
    the relative limit."""
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    import torch
    zm, trainer, (images, labels, mask) = _train_setup(
        bs, seed=1, arch=CAIT_ARCH, image_size=CAIT_SIZE)
    model = zm.model
    with torch.no_grad():
        _show_layerscale(dict(model.named_parameters()))
    model.train()
    x = trainer.eval_transform(images)

    def loss_and_grads():
        model.zero_grad(set_to_none=True)
        loss = cross_entropy_loss(model(x), labels, mask)
        loss.backward()
        return loss.item(), {n: p.grad.detach().clone()
                             for n, p in model.named_parameters()}

    _reset_counts()
    loss_k, grads_k = loss_and_grads()
    counts = _read_counts()
    with _plain_talking_heads():
        loss_p, grads_p = loss_and_grads()
    if _read_counts() != counts:
        raise AssertionError("the plain step launched a kernel")
    if counts != _want(talking_heads=CAIT_DEPTH):
        raise AssertionError(f"launches in the kernel step {counts}")
    shift = ("attn.proj_l.bias", "attn.k.bias")
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_p.items() if not n.endswith(shift)}
    worst = max(rel, key=rel.get)
    noise = [max(grads_k[n].norm().item(), g.norm().item())
             for n, g in grads_p.items() if n.endswith(shift)]
    row = {"arch": CAIT_ARCH, "bs": bs, "loss_kernel": loss_k,
           "loss_plain": loss_p, "loss_abs_diff": abs(loss_k - loss_p),
           "max_grad_rel_err": rel[worst], "worst_param": worst,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "max_shift_invariant_grad_norm": max(noise),
           "max_grad_norm": max(g.norm().item() for g in grads_p.values()),
           "launches": counts}
    _say(json.dumps({"cait_step_vs_plain": row}))
    if not (np.isfinite(loss_k) and row["loss_abs_diff"] <= STEP_LOSS_ATOL
            and rel[worst] <= STEP_GRAD_RTOL):
        raise AssertionError(f"cait kernel step vs plain step: {row} "
                             f"(limits loss {STEP_LOSS_ATOL}, grad "
                             f"{STEP_GRAD_RTOL})")
    return row


def _ab_inputs(B, N, C, seed):
    """A bf16 (B, N, C) block of std 1, bf16 weights in nn.Linear layout of
    std 1/sqrt(C) and biases of std 0.1, on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(7000 + seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    return (rnd(B, N, C), rnd(3 * C, C, scale=C ** -0.5),
            rnd(3 * C, scale=0.1), rnd(C, C, scale=C ** -0.5),
            rnd(C, scale=0.1))


def _port_path(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
    """The port's unfused attention block on the card (``Attention``'s
    third route): cuBLAS qkv product, the flash kernel, cuBLAS proj."""
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops.flash_attention import flash_attention_qkv
    B, N, C = x.shape
    qkv = F.linear(x, w_qkv, b_qkv).view(B, N, 3, num_heads, -1)
    o = flash_attention_qkv(qkv, scale=scale).reshape(B, N, C)
    return F.linear(o, w_proj, b_proj)


def _library_block(x, w_qkv, b_qkv, w_proj, b_proj, num_heads, scale):
    """The same function through PyTorch's own calls: cuBLAS products
    around ``scaled_dot_product_attention``."""
    import torch.nn.functional as F
    B, N, C = x.shape
    qkv = F.linear(x, w_qkv, b_qkv).view(B, N, 3, num_heads, -1)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    o = F.scaled_dot_product_attention(q, k, v, scale=scale)
    return F.linear(o.transpose(1, 2).reshape(B, N, C), w_proj, b_proj)


def _ab_bound_ms(B, N, C, packed):
    """8·B·N·C² + 4·B·N²·C operations; x read and the output written
    once, the bf16 weights and biases, and B4's qkv written."""
    from vit_torch_tpu_torch.ops.attn_block import attention_block_flops
    nbytes = (2 * B * N * C + 4 * C * C + 4 * C) * 2
    if packed:
        nbytes += 3 * B * N * C * 2
    return _bound(attention_block_flops(B, N, C), nbytes)


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def _smi_sample():
    """The card's SM clock (MHz), power draw (W) and temperature (C) from
    one nvidia-smi query, or None where it reads "[N/A]" or fails."""
    query = ["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
             "--format=csv,noheader,nounits"]
    try:
        out = subprocess.run(query, capture_output=True, text=True,
                             timeout=10).stdout.splitlines()[0]
        return dict(zip(("sm_mhz", "power_w", "temp_c"),
                        (float(v) for v in out.split(","))))
    except (IndexError, ValueError, OSError, subprocess.SubprocessError):
        return None


def check_attention_block(shape, seed, packed: bool = False):
    """B3 (row 3) or B4 (row 4, with its qkv output) vs the plain version on
    one (B, N, C, heads) shape; times the chain on CUDA events (the card's
    clocks and power read just before and just after, with the host
    otherwise idle) and, from one profiler pass, each of its two kernels'
    device time (the qkv product, attention and projection; the chain's
    is their sum) and launches; the plain version, the port's unfused
    path (cuBLAS + flash + cuBLAS) and the library's (cuBLAS + SDPA) on
    events and on the device."""
    import torch
    from vit_torch_tpu_torch.ops import attn_block as ab
    B, N, C, H = shape
    args = _ab_inputs(B, N, C, seed)
    scale = (C // H) ** -0.5
    if packed:
        def run():
            return ab.attention_block_packed_fwd(*args, num_heads=H)

        def plain():
            return ab.attention_block_packed_reference(*args, num_heads=H)
        out, qkv = run()
        torch.cuda.synchronize()
        ref, ref_qkv = plain()
        qkv_rel = _rel_err(qkv, ref_qkv)
    else:
        def run():
            return ab.attention_block(*args, num_heads=H)

        def plain():
            return ab.attention_block_reference(*args, num_heads=H)
        out = run()
        torch.cuda.synchronize()
        ref, qkv_rel = plain(), 0.0
    abs_err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref)
    name = "attention_block_packed" if packed else "attention_block"
    if not (torch.isfinite(out).all() and rel <= ATTN_BLOCK_RTOL
            and qkv_rel <= ATTN_BLOCK_RTOL):
        raise AssertionError(f"{name} {shape}: max abs err relative to "
                             f"max|plain| {rel}, qkv {qkv_rel} (limit "
                             f"{ATTN_BLOCK_RTOL})")
    del out, ref

    def library():
        return _library_block(*args, H, scale)

    smi = [_smi_sample()]
    ms = _time_ms(run, iters=200)
    smi.append(_smi_sample())
    (attn_device_ms, attn_seen), (qkv_device_ms, qkv_seen) = _device_times(
        run, ("attn_block_kernel", "attn_block_qkv_kernel"), iters=20)
    device_ms = attn_device_ms + qkv_device_ms
    if not (attn_device_ms > 0 and qkv_device_ms > 0):
        raise AssertionError(f"{name} {shape}: the profiler saw no kernel "
                             f"of the chain ({attn_device_ms}, "
                             f"{qkv_device_ms} ms)")
    plain_ms = _time_ms(plain, iters=5)
    port_ms = _time_ms(lambda: _port_path(*args, H, scale), iters=50)
    library_ms = _time_ms(library, iters=50)
    library_device_ms = _device_ms(library, "")   # every kernel it runs
    bound_ms, bound_by = _ab_bound_ms(B, N, C, packed)
    plan = ab.launch_plan(B, N, C, H, packed=packed)._asdict()
    row = {"shape": list(shape), "max_abs_err": abs_err, "max_rel_err": rel,
           "qkv_max_rel_err": qkv_rel if packed else None, "ms": ms,
           "device_ms": device_ms, "attn_kernel_device_ms": attn_device_ms,
           "qkv_device_ms": qkv_device_ms,
           "qkv_tflops": 6 * B * N * C * C / qkv_device_ms / 1e9,
           "plain_ms": plain_ms, "port_path_ms": port_ms,
           "library_ms": library_ms, "library_device_ms": library_device_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
           "profiled_launches_per_call": [attn_seen, qkv_seen],
           "smi_before_after_events": smi}
    _say(f"kernel check {name}", json.dumps(row))
    return row


def check_attention_block_grads(shape, seed, packed: bool = False):
    """All five gradients of B3 or B4 through their autograd Functions vs
    autograd through the plain versions on one shape; times a forward and
    backward of each and of the port's unfused path."""
    import torch
    from vit_torch_tpu_torch.ops import attn_block as ab
    from vit_torch_tpu_torch.ops import flash_attention as fa
    B, N, C, H = shape
    leaves = [t.requires_grad_(True) for t in _ab_inputs(B, N, C, seed)]
    gen = torch.Generator(device="cuda").manual_seed(8000 + seed)
    dout = torch.randn((B, N, C), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    scale = (C // H) ** -0.5
    if packed:
        fn = ab.attention_block_packed

        def ref_fn(*a, num_heads):
            return ab.attention_block_packed_reference(
                *a, num_heads=num_heads)[0]
    else:
        fn, ref_fn = ab.attention_block, ab.attention_block_reference
    before = fa.flash_attention_bwd.launches
    got = torch.autograd.grad(fn(*leaves, num_heads=H), leaves, dout)
    torch.cuda.synchronize()
    bwd = fa.flash_attention_bwd.launches - before
    if bwd != (0 if packed else 1):
        raise AssertionError(f"{fn.__name__} grad launched the flash "
                             f"backward {bwd} times")
    want = torch.autograd.grad(ref_fn(*leaves, num_heads=H), leaves, dout)
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    if not (finite and max(rel) <= ATTN_BLOCK_GRAD_RTOL):
        raise AssertionError(f"{fn.__name__} grads {shape}: error relative "
                             f"to max|plain| {rel} (limit "
                             f"{ATTN_BLOCK_GRAD_RTOL})")
    ms = _time_ms(lambda: torch.autograd.grad(fn(*leaves, num_heads=H),
                                              leaves, dout), iters=10)
    port_ms = _time_ms(lambda: torch.autograd.grad(
        _port_path(*leaves, H, scale), leaves, dout), iters=10)
    row = {"shape": list(shape), "grad_rel_err": rel, "fwd_bwd_ms": ms,
           "port_path_fwd_bwd_ms": port_ms}
    _say(f"grad check {fn.__name__}", json.dumps(row))
    return row


def _plain_attention_block():
    """B3 and B4 on their plain versions (autograd through them, no
    kernel), patched in for the kernel-vs-plain comparisons."""
    import contextlib
    from vit_torch_tpu_torch.ops import attn_block as ab

    def packed(*args, **kw):
        return ab.attention_block_packed_reference(*args, **kw)[0]

    stack = contextlib.ExitStack()
    stack.enter_context(mock.patch.object(ab, "attention_block",
                                          ab.attention_block_reference))
    stack.enter_context(mock.patch.object(ab, "attention_block_packed",
                                          packed))
    return stack


def attention_block_through_cli(workdir: str, mode: str):
    """dino_vits16 @224 bs64 through ``cli.main`` with B3 on
    (``VITX_FUSED_ATTN=1``): ``lineareval`` (train steps under no_grad),
    ``lineareval_cached`` (the backbone once over each split) and
    ``finetune``; or ``small_finetune``, dino_vitb8 @32 bs128 with B4 on
    (``VITX_PACKED_ATTN=1``).  Every backbone forward launches the block's
    kernel once per block; a B3 fine-tune step's backward recomputes each
    block through the flash kernels (one forward and one backward launch
    each), B4's is analytic; no plain block version runs."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.ops import attn_block as ab
    plain = (ab.attention_block_reference, ab.attention_block_packed_reference)
    for fn in plain:
        fn.calls = 0
    if mode == "small_finetune":
        steps = SYNTHETIC_N // SMALL_BS
        argv, env = SMALL_TRAIN_ARGS, {"VITX_PACKED_ATTN": "1"}
        want = _want(attention_block_packed=12 * 2 * steps)
    else:
        steps = SYNTHETIC_N // VITS_BS
        extra = {"lineareval": ["--lineareval"],
                 "lineareval_cached": ["--lineareval", "--cache_features"],
                 "finetune": []}[mode]
        argv, env = VITS_TRAIN_ARGS + extra, {"VITX_FUSED_ATTN": "1"}
        recompute = VITS_DEPTH * steps if mode == "finetune" else 0
        want = _want(attention_block=VITS_DEPTH * 2 * steps,
                     flash_attention_fwd=recompute,
                     flash_attention_bwd=recompute)
    with mock.patch.dict(os.environ, env):
        counts = _run_cli(cli_main.main, argv, f"{workdir}/ab_{mode}.json",
                          f"attention_block_{mode}", want)
    if any(fn.calls for fn in plain):
        raise AssertionError(f"{mode}: the plain attention blocks ran "
                             f"{[fn.calls for fn in plain]} times")
    return counts


def _time_flags(trainer, batch, flag: str, iters: int, eval_x=None):
    """Steady-state steps (and, with ``eval_x``, the eval forward) with the
    block's flag off, on, on, off, so that drift falls on both sides:
    step ms and launches per step of each run, the profile of the first
    run with the kernel on."""
    import torch
    runs = {"0": [], "1": []}
    for value in ("0", "1", "1", "0"):
        with mock.patch.dict(os.environ, {flag: value}):
            t = _time_train_steps(trainer, batch, iters)
            row = {"step_ms": t["step_ms"], "host_step_ms": t["host_step_ms"],
                   "launches_per_step": t["launches_per_step"],
                   "peak_mem_gb": t["peak_mem_gb"],
                   "device_busy_ms": t["profile"]["device_busy_ms"],
                   "idle_share": t["profile"]["idle_share"]}
            if value == "1" and not runs["1"]:
                row["profile"] = t["profile"]
            if eval_x is not None:
                trainer.model.eval()
                with torch.no_grad():
                    row["eval_forward_ms"] = _time_ms(
                        lambda: trainer.model(eval_x), iters=10)
                trainer.model.train()
            runs[value].append(row)
    return {"kernel_on": runs["1"], "kernel_off": runs["0"]}


def steady_state_attention_block(iters: int = 12):
    """B3 against the port's unfused path (cuBLAS + flash + cuBLAS) on
    whole steps of dino_vits16 @224: the linear-eval step and the eval
    forward at bs64 and bs128, the fine-tune step at bs64; and B4 against
    it on the dino_vitb8 @32 bs128 fine-tune step.  MFU with ``bench.py``'s
    FLOPs (1 x forward for linear eval, 3 x for fine-tuning)."""
    import torch
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    rows = {}
    for name, arch, size, bs, lineareval, flag in (
            ("vits16_lineareval_bs64", VITS_ARCH, VITS_SIZE, 64, True,
             "VITX_FUSED_ATTN"),
            ("vits16_lineareval_bs128", VITS_ARCH, VITS_SIZE, 128, True,
             "VITX_FUSED_ATTN"),
            ("vits16_finetune_bs64", VITS_ARCH, VITS_SIZE, 64, False,
             "VITX_FUSED_ATTN"),
            ("vitb8_32px_finetune_bs128", ARCH, SMALL_SIZE, SMALL_BS, False,
             "VITX_PACKED_ATTN")):
        zm, trainer, batch = _train_setup(bs, arch=arch, image_size=size,
                                          lineareval=lineareval)
        zm.model.train()
        eval_x = trainer.eval_transform(batch[0]) if lineareval else None
        row = _time_flags(trainer, batch, flag, iters, eval_x)
        flops = vit_flops(VIT_CONFIGS[arch], size) * bs
        step_flops = flops * (1 if lineareval else 3)
        for run in row["kernel_on"] + row["kernel_off"]:
            run["img_per_s"] = bs * 1e3 / run["step_ms"]
            run["mfu"] = step_flops / (run["step_ms"] / 1e3) / H100_BF16_FLOPS
            if "eval_forward_ms" in run:
                run["eval_forward_img_per_s"] = bs * 1e3 / run[
                    "eval_forward_ms"]
        kernel = ("attention_block_packed" if flag == "VITX_PACKED_ATTN"
                  else "attention_block")
        for run in row["kernel_on"]:
            if run["launches_per_step"][kernel] != 12:
                raise AssertionError(f"{name}: launches per step "
                                     f"{run['launches_per_step']}")
        for run in row["kernel_off"]:
            if run["launches_per_step"][kernel]:
                raise AssertionError(f"{name}: the kernel ran with {flag}=0")
        rows[name] = dict(row, arch=arch, image_size=size, bs=bs,
                          flag=flag, step_tflop=step_flops / 1e12)
        del zm, trainer, batch, eval_x
        torch.cuda.empty_cache()
    _say(json.dumps({"attention_block_steady_state": rows}))
    return rows


def _mlp_inputs(T, C, Hd, Co, seed, bias=True):
    """bf16 tokens of std 1, bf16 weights in nn.Linear layout of std
    1/sqrt(fan in) and biases of std 0.1 (or None), on the card."""
    import torch
    gen = torch.Generator(device="cuda").manual_seed(9000 + seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    return (rnd(T, C), rnd(Hd, C, scale=C ** -0.5),
            rnd(Hd, scale=0.1) if bias else None,
            rnd(Co, Hd, scale=Hd ** -0.5),
            rnd(Co, scale=0.1) if bias else None)


def _library_mlp(x, w1, b1, w2, b2):
    """The port's default MLP on the card: cuBLAS fc1, PyTorch's GELU,
    cuBLAS fc2."""
    import torch.nn.functional as F
    return F.linear(F.gelu(F.linear(x, w1, b1)), w2, b2)


def _mlp_bound_ms(T, C, Hd, Co):
    """2·T·Hd·(C + Co) operations; x read and the output written once, the
    bf16 weights and biases."""
    from vit_torch_tpu_torch.ops.fused_mlp import mlp_flops
    return _bound(mlp_flops(T, C, Hd, Co),
                  (T * C + T * Co + Hd * C + Co * Hd + Hd + Co) * 2)


def _ptxas_lines(log: str):
    """The ``ptxas -v`` lines of one build log that name a kernel or give
    its registers, shared memory and spills."""
    return [line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line or "Potential Performance Loss" in line]


def ptxas_gate(kernel: str, log: str):
    """One kernel library's ``ptxas -v`` lines; raises unless the log
    reports its spills and every instance spills nothing and keeps its
    wgmma asynchronous (ptxas's C7512 "Potential Performance Loss" note
    says it serialised them for want of registers)."""
    lines = _ptxas_lines(log)
    spills = [int(n) for line in lines
              for n in re.findall(r"(\d+) bytes spill", line)]
    if (not spills or any(spills)
            or any("Potential Performance Loss" in line for line in lines)):
        raise AssertionError(f"{kernel}: no ptxas report, spills or "
                             "serialised wgmma: " + " | ".join(lines))
    return lines


def check_fused_mlp(shape, seed):
    """B12 (row 12) vs its plain version on one (T, C, hidden, out) shape;
    times the kernel on CUDA events and its device time from the profiler,
    the plain version and the port's default MLP (cuBLAS + GELU +
    cuBLAS)."""
    import torch
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co, bias = shape
    args = _mlp_inputs(T, C, Hd, Co, seed, bias)
    before = fm.fused_mlp.launches
    out = fm.fused_mlp(*args)
    torch.cuda.synchronize()
    if fm.fused_mlp.launches != before + 1:
        raise AssertionError(f"fused_mlp {shape} did not launch once")
    ref = fm.fused_mlp_reference(*args)
    abs_err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref)
    if not (torch.isfinite(out).all() and rel <= MLP_RTOL):
        raise AssertionError(f"fused_mlp {shape}: max abs err relative to "
                             f"max|plain| {rel} > {MLP_RTOL}")
    del out, ref
    ms = _time_ms(lambda: fm.fused_mlp(*args), iters=20)
    device_ms = _device_ms(lambda: fm.fused_mlp(*args), "fused_mlp_kernel")
    plain_ms = _time_ms(lambda: fm.fused_mlp_reference(*args), iters=3)
    library_ms = _time_ms(lambda: _library_mlp(*args), iters=20)
    bound_ms, bound_by = _mlp_bound_ms(T, C, Hd, Co)
    # the plan the wrapper passes to the kernel: one block per row tile
    # and slab; each slab past the first recomputes fc1
    plan = fm.launch_plan(
        T, C, Hd, Co,
        torch.cuda.get_device_properties(0).multi_processor_count)._asdict()
    plan["grid"] = "one block per (row tile, slab)"
    flops = fm.mlp_flops(T, C, Hd, Co)
    row = {"shape": [T, C, Hd, Co], "biases": bias, "max_abs_err": abs_err,
           "max_rel_err": rel, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
           "tflops": flops / device_ms / 1e9,
           "library_tflops": flops / library_ms / 1e9,
           "bound_share": bound_ms / device_ms}
    _say("kernel check fused_mlp", json.dumps(row))
    return row


def compare_fused_mlp_layouts(shape, seed):
    """B12 with each row layout forced on one shape, both against the plain
    version; CUDA-event times of each, twice, in the order 64, 128, 128,
    64 rows, beside the layout launch_plan takes on this card."""
    import torch
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co = shape
    args = _mlp_inputs(T, C, Hd, Co, seed)
    ref = fm.fused_mlp_reference(*args)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    row = {"shape": list(shape), "sms": sms,
           "chosen_rows": fm.launch_plan(T, C, Hd, Co, sms).block_rows,
           "max_rel_err": {}, "ms": {64: [], 128: []}}
    plans = {rows: fm.launch_plan(T, C, Hd, Co, block_rows=rows)
             for rows in (64, 128)}
    for rows, plan in plans.items():
        out = fm.launch(*args, plan)
        rel = _rel_err(out, ref)
        if not (torch.isfinite(out).all() and rel <= MLP_RTOL):
            raise AssertionError(f"fused_mlp {shape} at {rows} rows: max "
                                 f"abs err relative to max|plain| {rel} > "
                                 f"{MLP_RTOL}")
        row["max_rel_err"][rows] = rel
    del out, ref
    for rows in (64, 128, 128, 64):
        row["ms"][rows].append(
            _time_ms(lambda: fm.launch(*args, plans[rows]), iters=20))
    _say("kernel check fused_mlp layouts", json.dumps(row))
    return row


def check_fused_mlp_grads(shape, seed):
    """All five gradients of B12 through its autograd Function (one kernel
    launch forward, the backward a recompute through cuBLAS) vs autograd
    through the plain version; times a forward and backward of each and of
    the port's default MLP."""
    import torch
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co, bias = shape
    leaves = [t.requires_grad_(True)
              for t in _mlp_inputs(T, C, Hd, Co, seed, bias)]
    gen = torch.Generator(device="cuda").manual_seed(9500 + seed)
    dout = torch.randn((T, Co), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    before = fm.fused_mlp.launches
    got = torch.autograd.grad(fm.fused_mlp(*leaves), leaves, dout)
    torch.cuda.synchronize()
    if fm.fused_mlp.launches != before + 1:
        raise AssertionError("fused_mlp grad: not one forward launch")
    want = torch.autograd.grad(fm.fused_mlp_reference(*leaves), leaves, dout)
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    if not (finite and max(rel) <= MLP_GRAD_RTOL):
        raise AssertionError(f"fused_mlp grads {shape}: error relative to "
                             f"max|plain| {rel} (limit {MLP_GRAD_RTOL})")
    ms = _time_ms(lambda: torch.autograd.grad(fm.fused_mlp(*leaves), leaves,
                                              dout), iters=10)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        _library_mlp(*leaves), leaves, dout), iters=10)
    row = {"shape": [T, C, Hd, Co], "grad_rel_err": rel, "fwd_bwd_ms": ms,
           "library_fwd_bwd_ms": library_ms}
    _say("grad check fused_mlp", json.dumps(row))
    return row


def _flat_windows(case, d):
    """The block case's map rolled by -shift and partitioned into
    (Bn, N, C) windows on the card, as the Swin block feeds B7."""
    import torch
    from vit_torch_tpu_torch.ops import window_block as wb
    _, _, _, _, w, shift = case
    x = torch.roll(d["x"], (-shift, -shift), dims=(1, 2)) if shift else d["x"]
    return wb.window_partition(x, w)


def check_window_block_flat(case, seed):
    """B7 (``window_block``, row 7) vs its plain version on the windows of
    one block case; times the chain on CUDA events and its kernels' device
    time, and the plain version; B8's bound (the same function)."""
    import torch
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift = case
    d = _block_inputs(case, seed)
    args = (_flat_windows(case, d), *d["qkv"], d["bias"], d["mask"],
            *d["proj"])
    heads = C // 32
    out = wb.window_block(*args, num_heads=heads)
    torch.cuda.synchronize()
    ref = wb.window_block_reference(*args, num_heads=heads)
    abs_err = (out.float() - ref.float()).abs().max().item()
    rel = _rel_err(out, ref)
    del ref
    if not (torch.isfinite(out).all() and rel <= BLOCK_RTOL):
        raise AssertionError(f"window_block {case}: max abs err relative to "
                             f"max|plain| {rel} > {BLOCK_RTOL}")

    def run():
        return wb.window_block(*args, num_heads=heads)

    ms = _time_ms(run, iters=20)
    device_ms = _device_ms(run, ("window_gemm_kernel",
                                 "window_attn_fwd_kernel"))
    plain_ms = _time_ms(lambda: wb.window_block_reference(
        *args, num_heads=heads), iters=3)
    bound_ms, bound_by = _block_bound_ms(case, False)
    row = {"case": list(case), "shape": list(args[0].shape),
           "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
           "device_ms": device_ms, "plain_ms": plain_ms, "library_ms": None,
           "bound_ms": bound_ms, "bound_by": bound_by}
    _say("kernel check window_block", json.dumps(row))
    return row


def check_window_block_flat_grads(case, seed):
    """The gradients of B7 through its autograd Function (the chain
    forward, B6 in the backward) vs autograd through its plain version,
    every input but the mask; times one forward and backward."""
    import torch
    from vit_torch_tpu_torch.ops import window_attention as wa
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift = case
    d = _block_inputs(case, seed)
    leaves = [t.detach().clone().requires_grad_(True) for t in (
        _flat_windows(case, d), *d["qkv"], d["bias"], *d["proj"])]
    x, wq, bq, bias, wp, bp = leaves
    args = (x, wq, bq, bias, d["mask"], wp, bp)
    gen = torch.Generator(device="cuda").manual_seed(5500 + seed)
    dout = torch.randn(x.shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    before = wa.window_attention_bwd.launches
    got = torch.autograd.grad(wb.window_block(*args, num_heads=C // 32),
                              leaves, dout)
    torch.cuda.synchronize()
    if wa.window_attention_bwd.launches != before + 1:
        raise AssertionError("window_block grad did not launch B6 once")
    want = torch.autograd.grad(wb.window_block_reference(
        *args, num_heads=C // 32), leaves, dout)
    rel = [_rel_err(g, r) for g, r in zip(got, want)]
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    if not (finite and max(rel) <= BLOCK_GRAD_RTOL):
        raise AssertionError(f"window_block grads {case}: error relative to "
                             f"max|plain| {rel} (limit {BLOCK_GRAD_RTOL})")
    ms = _time_ms(lambda: torch.autograd.grad(
        wb.window_block(*args, num_heads=C // 32), leaves, dout), iters=5)
    row = {"case": list(case), "grad_rel_err": rel, "fwd_bwd_ms": ms}
    _say("grad check window_block", json.dumps(row))
    return row


def _plain_deit():
    """The DeiT blocks' kernels, B12 and the flash attention, on their
    plain versions (autograd through them, no kernel), patched in for the
    kernel-vs-plain comparisons."""
    import contextlib
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    stack = contextlib.ExitStack()
    stack.enter_context(_plain_attention())
    stack.enter_context(mock.patch.object(fm, "fused_mlp",
                                          fm.fused_mlp_reference))
    return stack


def deit_through_cli(workdir: str, mode: str):
    """deit_base_distilled_patch16_224 @224 bs32 through ``cli.main`` with
    B12 on (``VITX_FUSED_MLP=1``): ``lineareval`` (train steps under
    no_grad), ``lineareval_cached`` (the backbone once over each whole
    split) and ``finetune``.  Every backbone forward launches B12 and the
    flash forward once per block; the fine-tune's backward recomputes each
    MLP through cuBLAS (no B12 launch) and runs the flash backward once
    per block; no plain MLP runs."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    extra = {"lineareval": ["--lineareval"],
             "lineareval_cached": ["--lineareval", "--cache_features"],
             "finetune": []}[mode]
    samples = SYNTHETIC_N if mode == "lineareval_cached" else DEIT_SAMPLES
    steps = samples // TRAIN_BS
    forwards = DEIT_DEPTH * 2 * steps
    want = _want(fused_mlp=forwards, flash_attention_fwd=forwards,
                 flash_attention_bwd=DEIT_DEPTH * steps
                 if mode == "finetune" else 0)
    fm.fused_mlp_reference.calls = 0
    with mock.patch.dict(os.environ, {"VITX_FUSED_MLP": "1"}):
        counts = _run_cli(cli_main.main, DEIT_TRAIN_ARGS + extra,
                          f"{workdir}/deit_{mode}.json", f"deit_{mode}",
                          want, samples=samples)
    if fm.fused_mlp_reference.calls:
        raise AssertionError(f"deit_{mode}: the plain MLP ran "
                             f"{fm.fused_mlp_reference.calls} times")
    return counts


def steady_state_deit(iters: int = 12):
    """B12 against the port's default MLP (cuBLAS + GELU + cuBLAS) on whole
    deit_base_distilled_patch16_224 @224 bs32 steps: the linear-eval step
    with the eval forward, and the fine-tune step, each with the flag off,
    on, on, off.  MFU with ``bench.py``'s FLOPs (1 x forward for linear
    eval, 3 x for fine-tuning)."""
    import torch
    from vit_torch_tpu_torch.models.deit import deit_flops
    rows = {}
    for name, lineareval in (("deit_lineareval_bs32", True),
                             ("deit_finetune_bs32", False)):
        zm, trainer, batch = _train_setup(TRAIN_BS, arch=DEIT_ARCH,
                                          image_size=DEIT_SIZE,
                                          lineareval=lineareval)
        zm.model.train()
        eval_x = trainer.eval_transform(batch[0]) if lineareval else None
        row = _time_flags(trainer, batch, "VITX_FUSED_MLP", iters, eval_x)
        flops = deit_flops(DEIT_ARCH, DEIT_SIZE) * TRAIN_BS
        step_flops = flops * (1 if lineareval else 3)
        for run in row["kernel_on"] + row["kernel_off"]:
            run["img_per_s"] = TRAIN_BS * 1e3 / run["step_ms"]
            run["mfu"] = step_flops / (run["step_ms"] / 1e3) / H100_BF16_FLOPS
            if "eval_forward_ms" in run:
                run["eval_forward_img_per_s"] = TRAIN_BS * 1e3 / run[
                    "eval_forward_ms"]
        for run in row["kernel_on"]:
            if run["launches_per_step"]["fused_mlp"] != DEIT_DEPTH:
                raise AssertionError(f"{name}: launches per step "
                                     f"{run['launches_per_step']}")
        for run in row["kernel_off"]:
            if run["launches_per_step"]["fused_mlp"]:
                raise AssertionError(f"{name}: B12 ran with the flag at 0")
        rows[name] = dict(row, arch=DEIT_ARCH, image_size=DEIT_SIZE,
                          bs=TRAIN_BS, flag="VITX_FUSED_MLP",
                          step_tflop=step_flops / 1e12)
        del zm, trainer, batch, eval_x
        torch.cuda.empty_cache()
    _say(json.dumps({"deit_steady_state": rows}))
    return rows


def swin_flat_through_cli(workdir: str):
    """swin_base_384 linear eval @384 bs32 through ``cli.main_swin`` with
    ``VITX_FUSED_SPATIAL=0``, 4 + 4 steps: in a train step block 0 (drop
    path 0) takes B9 and the 23 others B7 over windows partitioned by
    PyTorch ops; every eval step takes B9 in all 24 blocks; B8 never
    runs."""
    from vit_torch_tpu_torch.cli import main_swin
    steps = SWIN_FLAT_SAMPLES // TRAIN_BS
    want = _want(window_attention=SWIN_DEPTH * 2 * steps,
                 window_block=(SWIN_DEPTH - 1) * steps,
                 window_block_full_spatial=(1 + SWIN_DEPTH) * steps)
    with mock.patch.dict(os.environ, {"VITX_FUSED_SPATIAL": "0"}):
        return _run_cli(main_swin.main, SWIN_TRAIN_ARGS + [
            "--lineareval", "--scan", "0", "--limit_train",
            str(SWIN_FLAT_SAMPLES), "--limit_test", str(SWIN_FLAT_SAMPLES)],
            f"{workdir}/swin_flat_lineareval.json", "swin_flat_lineareval",
            want, samples=SWIN_FLAT_SAMPLES)


def _conv_args(arch: str):
    return ["--dataset", "synthetic", "--arch", arch, "--image_size", "224",
            "--bs", str(TRAIN_BS), "--epoch", "1", "--opt", "adamw",
            "--lr", "1e-4", "--fc", "512"]


def conv_family_through_cli(workdir: str, arch: str, mode: str,
                            per_forward, env):
    """xcit_small_24_p16 or resnext50_32x4d @224 bs32 through ``cli.main``,
    one synthetic epoch: ``lineareval`` (the frozen backbone in train mode,
    its BN statistics updated), ``lineareval_cached`` (the backbone once
    over each split in eval mode) or ``finetune``.  Every backbone forward
    launches each kernel of ``per_forward`` that many times (B12 in every
    XCiT MLP under ``VITX_FUSED_MLP=1``; ResNeXt runs no kernel); no plain
    MLP runs."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    extra = {"lineareval": ["--lineareval"],
             "lineareval_cached": ["--lineareval", "--cache_features"],
             "finetune": []}[mode]
    steps = SYNTHETIC_N // TRAIN_BS
    want = _want(**{k: n * 2 * steps for k, n in per_forward.items()})
    fm.fused_mlp_reference.calls = 0
    with mock.patch.dict(os.environ, env):
        counts = _run_cli(cli_main.main, _conv_args(arch) + extra,
                          f"{workdir}/{arch}_{mode}.json", f"{arch}_{mode}",
                          want)
    if fm.fused_mlp_reference.calls:
        raise AssertionError(f"{arch}_{mode}: the plain MLP ran "
                             f"{fm.fused_mlp_reference.calls} times")
    return counts


def _with_rates(run, step_flops):
    run["img_per_s"] = TRAIN_BS * 1e3 / run["step_ms"]
    run["step_tflop"] = step_flops / 1e12
    run["mfu"] = step_flops / (run["step_ms"] / 1e3) / H100_BF16_FLOPS
    return run


def steady_state_xcit(iters: int = 12):
    """xcit_small_24_p16 @224 bs32 fine-tune steps with the MLPs on the
    cuBLAS chain and on B12 (``VITX_FUSED_MLP`` off, on, on, off): CUDA-
    event step time, device busy time and idle share from a profile,
    ``max_memory_allocated``, MFU with 3 x ``xcit_flops``, the profile of
    the first run with B12 on and of the first without, by kernel group."""
    import torch
    from vit_torch_tpu_torch.models.xcit import XCIT_CONFIGS, xcit_flops
    zm, trainer, batch = _train_setup(TRAIN_BS, arch=XCIT_ARCH,
                                      image_size=XCIT_SIZE)
    zm.model.train()
    step_flops = 3 * xcit_flops(XCIT_CONFIGS[XCIT_ARCH], XCIT_SIZE) * TRAIN_BS
    runs = {"0": [], "1": []}
    for value in ("0", "1", "1", "0"):
        with mock.patch.dict(os.environ, {"VITX_FUSED_MLP": value}):
            t = _time_train_steps(trainer, batch, iters)
        run = _with_rates({k: t[k] for k in (
            "step_ms", "host_step_ms", "launches_per_step", "peak_mem_gb")},
            step_flops)
        run.update(device_busy_ms=t["profile"]["device_busy_ms"],
                   idle_share=t["profile"]["idle_share"])
        if not runs[value]:
            run["profile"] = t["profile"]
        want = XCIT_MLPS if value == "1" else 0
        if run["launches_per_step"] != _want(fused_mlp=want):
            raise AssertionError(f"xcit step with VITX_FUSED_MLP={value}: "
                                 f"launches {run['launches_per_step']}")
        runs[value].append(run)
    row = {"arch": XCIT_ARCH, "image_size": XCIT_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "kernel_on": runs["1"],
           "kernel_off": runs["0"]}
    _say(json.dumps({"xcit_finetune_step": row}))
    del zm, trainer, batch
    torch.cuda.empty_cache()
    return row


def steady_state_resnext(iters: int = 12):
    """resnext50_32x4d @224 bs32: the fine-tune step (CUDA events, device
    busy time and idle share, ``max_memory_allocated``, MFU with 3 x
    ``resnet_flops``, a profile by kernel group), then the bs32 eval
    forward (inference mode, as served) with the conv+BN fold on and off
    in turns (``VITX_FOLD_BN`` 1, 0, 0, 1), each with its device busy
    time; the two sides' features are held against each other."""
    import torch
    from vit_torch_tpu_torch.models.resnet import RESNET_CONFIGS, resnet_flops
    zm, trainer, batch = _train_setup(TRAIN_BS, arch=RESNEXT_ARCH,
                                      image_size=RESNEXT_SIZE)
    zm.model.train()
    fwd_flops = resnet_flops(RESNET_CONFIGS[RESNEXT_ARCH],
                             RESNEXT_SIZE) * TRAIN_BS
    t = _time_train_steps(trainer, batch, iters)
    if t["launches_per_step"] != _want():
        raise AssertionError(f"resnext step launched {t['launches_per_step']}")
    step = _with_rates({k: t[k] for k in (
        "step_ms", "host_step_ms", "launches_per_step", "peak_mem_gb",
        "profile")}, 3 * fwd_flops)
    step.update(device_busy_ms=t["profile"]["device_busy_ms"],
                idle_share=t["profile"]["idle_share"])
    model = zm.model.eval()
    x = trainer.eval_transform(batch[0])
    fold = {"1": [], "0": []}
    feats = {}
    for value in ("1", "0", "0", "1"):
        with mock.patch.dict(os.environ, {"VITX_FOLD_BN": value}), \
                torch.inference_mode():
            ms = _time_ms(lambda: model(x), iters=10)
            prof = _profile_calls(lambda: model(x), iters=2)
            feats[value] = model(x).float()
        fold[value].append({
            "ms": ms, "img_per_s": TRAIN_BS * 1e3 / ms,
            "mfu": fwd_flops / (ms / 1e3) / H100_BF16_FLOPS,
            "device_busy_ms": prof["device_busy_ms"],
            "groups_ms": prof["groups_ms"]})
    err = ((feats["1"] - feats["0"]).abs().max()
           / feats["0"].abs().max()).item()
    if not err <= CONV_LOGITS_RTOL:
        raise AssertionError(f"resnext folded vs unfolded logits: {err}")
    row = {"arch": RESNEXT_ARCH, "image_size": RESNEXT_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "finetune_step": step,
           "eval_forward_fold_on": fold["1"],
           "eval_forward_fold_off": fold["0"],
           "fold_vs_unfold_rel_err": err}
    _say(json.dumps({"resnext_steady_state": row}))
    del zm, trainer, batch, model, x
    torch.cuda.empty_cache()
    return row


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vit_torch_tpu_torch.ops import _build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _say(f"device {name} | count {torch.cuda.device_count()} | torch "
         f"{torch.__version__} cuda {torch.version.cuda} | {smi}")

    _say(f"build seconds {_build.build():.2f} ({', '.join(_build.KERNELS)})")
    for kernel, log in _build.LOGS.items():   # registers, smem, spills
        _say(f"ptxas {kernel}: " + " | ".join(_ptxas_lines(log)))
    # the wgmma kernels: no spill, no serialised wgmma
    mlp_ptxas = ptxas_gate("fused_mlp", _build.LOGS.get("fused_mlp", ""))
    ab_ptxas = ptxas_gate("attn_block", _build.LOGS.get("attn_block", ""))
    window_ptxas = {k: ptxas_gate(k, _build.LOGS.get(k, ""))
                    for k in ("window_gemm", "window_attention_fwd",
                              "window_attention_bwd")}
    th_ptxas = ptxas_gate("talking_heads", _build.LOGS.get("talking_heads",
                                                           ""))
    flash_ptxas = {k: ptxas_gate(k, _build.LOGS.get(k, ""))
                   for k in ("flash_attention_fwd", "flash_attention_bwd")}

    rows = [check_flash_kernel(shape, seed=i)
            for i, shape in enumerate(ATTN_SHAPES)]
    serving_row = rows[0]
    bwd_rows = [check_flash_bwd_kernel(shape, seed=i)
                for i, shape in enumerate(BWD_SHAPES)]
    train_row = bwd_rows[0]

    attn_rows = [check_window_attention(case, seed=i)
                 for i, case in enumerate(SWIN_BLOCKS)]
    block_rows = [check_window_blocks(case, seed=i)
                  for i, case in enumerate(SWIN_BLOCKS)]
    attn_bwd_rows = [check_window_attention_bwd(case, seed=i)
                     for i, case in enumerate(SWIN_BLOCKS)]
    # the headline case, window 7 and the ragged case
    for i in (0, 7, 8):
        check_window_block_grads(SWIN_BLOCKS[i], seed=i)
    th_rows = [check_talking_heads(shape, seed=i)
               for i, shape in enumerate(TH_SHAPES)]
    th_rows.append(check_talking_heads(TH_SHAPES[0], seed=len(TH_SHAPES),
                                       bnc=True))
    ab_rows = [check_attention_block(shape, seed=i)
               for i, shape in enumerate(AB_SHAPES)]
    abp_rows = [check_attention_block(shape, seed=i, packed=True)
                for i, shape in enumerate(AB_PACKED_SHAPES)]
    ab_grads = [check_attention_block_grads(AB_SHAPES[0], seed=0),
                check_attention_block_grads(AB_PACKED_SHAPES[0], seed=1,
                                            packed=True)]
    mlp_rows = [check_fused_mlp(shape, seed=i)
                for i, shape in enumerate(MLP_SHAPES)]
    mlp_layouts = [compare_fused_mlp_layouts(shape, seed=i)
                   for i, shape in enumerate(MLP_LAYOUT_SHAPES)]
    mlp_grads = check_fused_mlp_grads(MLP_SHAPES[0], seed=0)
    flat_rows = [check_window_block_flat(case, seed=i)
                 for i, case in enumerate(SWIN_BLOCKS)]
    flat_grads = check_window_block_flat_grads(SWIN_BLOCKS[0], seed=0)

    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, swin_flops
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    with tempfile.TemporaryDirectory() as workdir:
        launches = serve_end_to_end(
            workdir, ARCH, IMAGE_SIZE, ("flash_attention_fwd",),
            _plain_attention, vit_flops(VIT_CONFIGS[ARCH], IMAGE_SIZE),
            LOGITS_ATOL, relative=False)
        finetune = train_through_cli(workdir, lineareval=False)
        lineareval = train_through_cli(workdir, lineareval=True)
    steady_state_train()
    compare_step_with_plain()

    with tempfile.TemporaryDirectory() as workdir:
        swin_serve = serve_end_to_end(
            workdir, SWIN_ARCH, SWIN_SIZE,
            ("window_attention", "window_block_full_spatial"),
            _plain_window_blocks,
            swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE),
            SWIN_LOGITS_RTOL, relative=True)
        swin_le = swin_lineareval_through_cli(workdir, cached=False)
        swin_cached = swin_lineareval_through_cli(workdir, cached=True)
        swin_ft = swin_finetune_through_cli(workdir)
    swin_step = steady_state_swin_lineareval()
    swin_ft_step = steady_state_swin_finetune()
    compare_swin_step_with_plain()

    from vit_torch_tpu_torch.models.cait import CAIT_CONFIGS, cait_flops
    with tempfile.TemporaryDirectory() as workdir:
        cait_paths = {"serve": serve_end_to_end(
            workdir, CAIT_ARCH, CAIT_SIZE, ("talking_heads",),
            _plain_talking_heads,
            cait_flops(CAIT_CONFIGS[CAIT_ARCH], CAIT_SIZE),
            CAIT_LOGITS_RTOL, relative=True, prepare=_show_layerscale)}
        for mode in ("lineareval", "lineareval_cached", "finetune"):
            cait_paths[mode] = cait_through_cli(workdir, mode)
    cait_steps = steady_state_cait()
    compare_cait_step_with_plain()

    with tempfile.TemporaryDirectory() as workdir:
        with mock.patch.dict(os.environ, {"VITX_FUSED_ATTN": "1"}):
            ab_paths = {"serve": serve_end_to_end(
                workdir, VITS_ARCH, VITS_SIZE, ("attention_block",),
                _plain_attention_block,
                vit_flops(VIT_CONFIGS[VITS_ARCH], VITS_SIZE),
                VITS_LOGITS_RTOL, relative=True, buckets=VITS_BUCKETS)}
        for mode in ("lineareval", "lineareval_cached", "finetune",
                     "small_finetune"):
            ab_paths[mode] = attention_block_through_cli(workdir, mode)
    ab_steps = steady_state_attention_block()
    compare_step_with_plain(
        arch=VITS_ARCH, image_size=VITS_SIZE, env={"VITX_FUSED_ATTN": "1"},
        plain=_plain_attention_block,
        want=_want(attention_block=VITS_DEPTH, flash_attention_fwd=VITS_DEPTH,
                   flash_attention_bwd=VITS_DEPTH),
        name="vits16_step_vs_plain")
    compare_step_with_plain(
        image_size=SMALL_SIZE, env={"VITX_PACKED_ATTN": "1"},
        plain=_plain_attention_block,
        want=_want(attention_block_packed=VIT_CONFIGS[ARCH].depth),
        name="vitb8_32px_step_vs_plain")

    from vit_torch_tpu_torch.models.deit import deit_flops
    with tempfile.TemporaryDirectory() as workdir:
        with mock.patch.dict(os.environ, {"VITX_FUSED_MLP": "1"}):
            deit_paths = {"serve": serve_end_to_end(
                workdir, DEIT_ARCH, DEIT_SIZE,
                ("fused_mlp", "flash_attention_fwd"), _plain_deit,
                deit_flops(DEIT_ARCH, DEIT_SIZE), DEIT_LOGITS_RTOL,
                relative=True)}
        for mode in ("lineareval", "lineareval_cached", "finetune"):
            deit_paths[mode] = deit_through_cli(workdir, mode)
        swin_flat = swin_flat_through_cli(workdir)
    deit_steps = steady_state_deit()
    compare_step_with_plain(
        arch=DEIT_ARCH, image_size=DEIT_SIZE, env={"VITX_FUSED_MLP": "1"},
        plain=_plain_deit,
        want=_want(fused_mlp=DEIT_DEPTH, flash_attention_fwd=DEIT_DEPTH,
                   flash_attention_bwd=DEIT_DEPTH),
        name="deit_step_vs_plain")

    from vit_torch_tpu_torch.models.resnet import RESNET_CONFIGS, resnet_flops
    from vit_torch_tpu_torch.models.xcit import XCIT_CONFIGS, xcit_flops
    xcit_env = {"VITX_FUSED_MLP": "1"}
    with tempfile.TemporaryDirectory() as workdir:
        with mock.patch.dict(os.environ, xcit_env):
            xcit_paths = {"serve": serve_end_to_end(
                workdir, XCIT_ARCH, XCIT_SIZE, ("fused_mlp",), None,
                xcit_flops(XCIT_CONFIGS[XCIT_ARCH], XCIT_SIZE),
                CONV_LOGITS_RTOL, relative=True, prepare=_show_conv_state,
                per_dispatch=XCIT_MLPS)}
        resnext_paths = {"serve": serve_end_to_end(
            workdir, RESNEXT_ARCH, RESNEXT_SIZE, (), None,
            resnet_flops(RESNET_CONFIGS[RESNEXT_ARCH], RESNEXT_SIZE),
            CONV_LOGITS_RTOL, relative=True, prepare=_show_conv_state,
            per_dispatch=1)}
        for mode in ("lineareval", "lineareval_cached", "finetune"):
            xcit_paths[mode] = conv_family_through_cli(
                workdir, XCIT_ARCH, mode, {"fused_mlp": XCIT_MLPS}, xcit_env)
            resnext_paths[mode] = conv_family_through_cli(
                workdir, RESNEXT_ARCH, mode, {}, {})
    xcit_steps = steady_state_xcit()
    resnext_steps = steady_state_resnext()

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "vit_torch_tpu/ops/flash_attention.py:251",
        "launches": launches["flash_attention_fwd"],
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": serving_row["ms"], "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"],
        "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"],
        "shape": serving_row["shape"],
        "launches_by_path": {
            "serve": launches["flash_attention_fwd"],
            "finetune": finetune["flash_attention_fwd"],
            "lineareval": lineareval["flash_attention_fwd"]},
        "ms_with_lse": train_row["fwd_with_lse_ms"],
        "max_abs_err_lse": max(r["max_abs_err_lse"] for r in bwd_rows),
        "device_ms": serving_row["device_ms"],
        "library_device_ms": serving_row["library_device_ms"],
        "library_backend": serving_row["library_backend"],
        "plan": serving_row["plan"],
        "ptxas": flash_ptxas["flash_attention_fwd"],
        "ms_device_plain_library_libdevice_bound_by_shape": [
            [r["shape"], r["ms"], r["device_ms"], r["plain_ms"],
             r["library_ms"], r["library_device_ms"], r["bound_ms"]]
            for r in rows]}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/flash_attention_bwd.cu",
        "replaces": "vit_torch_tpu/ops/flash_attention.py:292",
        "launches": finetune["flash_attention_bwd"],
        "max_abs_err": max(r["max_abs_err"] for r in bwd_rows),
        "max_rel_err": max(max(r["rel_err_dq_dk_dv"]) for r in bwd_rows),
        "ms": train_row["ms"], "plain_ms": train_row["plain_ms"],
        "bound_ms": train_row["bound_ms"],
        "bound_by": train_row["bound_by"],
        "library_ms": train_row["library_ms"],
        "shape": train_row["shape"],
        "launches_by_path": {
            "finetune": finetune["flash_attention_bwd"],
            "lineareval": lineareval["flash_attention_bwd"]},
        "ms_32px_bs128": bwd_rows[1]["ms"],
        "bound_ms_32px_bs128": bwd_rows[1]["bound_ms"],
        "device_ms": train_row["device_ms"],
        "device_ms_preprocess_main_convert":
            train_row["device_ms_preprocess_main_convert"],
        "library_device_ms": train_row["library_device_ms"],
        "library_backend": train_row["library_backend"],
        "plan": train_row["plan"],
        "ptxas": flash_ptxas["flash_attention_bwd"],
        "ms_device_split_plain_library_libdevice_bound_by_shape": [
            [r["shape"], r["ms"], r["device_ms"],
             r["device_ms_preprocess_main_convert"], r["plain_ms"],
             r["library_ms"], r["library_device_ms"], r["bound_ms"]]
            for r in bwd_rows]}]
    # the Swin rows: numbers at the headline shape (swin_base_384 bs32
    # stage 1, shifted), the other shapes beside them; launches of the
    # forward kernels from the linear-eval run (slice 3's main path, bench
    # config 4), of the backward from the fine-tune run (slice 4's)
    swin_paths = {"lineareval": swin_le, "lineareval_cached": swin_cached,
                  "serve": swin_serve, "finetune": swin_ft}
    for kernel, source, replaces, by_case in (
            ("window_attention", "window_attention_fwd.cu",
             "window_attention.py:164", attn_rows),
            ("window_attention_bwd", "window_attention_bwd.cu",
             "window_attention.py:196", attn_bwd_rows),
            ("window_block_spatial", "window_gemm.cu",
             "window_block.py:496", [r["window_block_spatial"]
                                     for r in block_rows]),
            ("window_block_full_spatial", "window_gemm.cu",
             "window_block.py:806", [r["window_block_full_spatial"]
                                     for r in block_rows])):
        head = by_case[0]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": f"vit_torch_tpu_torch/csrc/{source}",
            "replaces": f"vit_torch_tpu/ops/{replaces}",
            "launches": (swin_ft if kernel == "window_attention_bwd"
                         else swin_le)[kernel],
            "max_abs_err": max(r["max_abs_err"] for r in by_case),
            "ms": head["ms"], "plain_ms": head["plain_ms"],
            "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
            "library_ms": head["library_ms"], "case": head["case"],
            "device_ms": head.get("device_ms"),
            "launches_by_path": {p: c[kernel]
                                 for p, c in swin_paths.items()},
            "ms_device_plain_library_bound_by_case": [
                [r["case"], r["ms"], r.get("device_ms"), r["plain_ms"],
                 r["library_ms"], r["bound_ms"]] for r in by_case]})
        if kernel.startswith("window_block"):
            kernels[-1]["launch_device_ms_by_case"] = [
                [r["case"], r["launch_device_ms"]] for r in by_case]
        if kernel in ("window_attention", "window_attention_bwd"):
            kernels[-1]["ptxas"] = window_ptxas[source[:-3]]
            kernels[-1]["plan"] = head["plan"]
    # the window GEMM's products: numbers at the headline case's gathered
    # qkv launch (swin_base_384 bs32 stage 1, shifted), every launch of
    # B9 at every case beside them; launches from the linear-eval run
    gemm_rows = [r["window_gemm"] for r in block_rows]
    head = gemm_rows[0]["products"][0]
    kernels.append({
        "name": "window_gemm", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/window_gemm.cu",
        "replaces": "vit_torch_tpu/ops/window_block.py:806, "
                    "vit_torch_tpu/ops/window_block.py:496, "
                    "vit_torch_tpu/ops/window_block.py:247",
        "launches": swin_le["window_gemm"],
        "max_abs_err": max(p["max_abs_err"] for r in gemm_rows
                           for p in r["products"]),
        "max_rel_err": max(p["max_rel_err"] for r in gemm_rows
                           for p in r["products"]),
        "ms": head["device_ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_device_ms"],
        "library": "F.linear over contiguous rows (cuBLAS), device time",
        "library_backend": head["library_backend"],
        "case": gemm_rows[0]["case"], "launch": head["launch"],
        "ptxas": window_ptxas["window_gemm"],
        "launches_by_path": {p: c["window_gemm"]
                             for p, c in swin_paths.items()},
        "launch_T_K_N_device_tflops_share_lib_libdevice_indexselect_by_case":
            [[r["case"], [[p["launch"], p["T"], p["K"], p["N"],
                           p["device_ms"], p["tflops"], p["bound_share"],
                           p["library_ms"], p["library_device_ms"],
                           p["index_select_linear_ms"]]
                          for p in r["products"]]] for r in gemm_rows]})
    b9_entry = next(k for k in kernels
                    if k["name"] == "window_block_full_spatial")
    b9_entry["lineareval_step_ms"] = swin_step["lineareval_step_ms"]
    b9_entry["eval_forward_ms"] = swin_step["eval_forward_ms"]
    b9_entry["eval_forward_busy_ms"] = (
        swin_step["eval_forward_profile"]["device_busy_ms"])
    b9_entry["finetune_step_ms"] = swin_ft_step["finetune_step_ms"]
    bwd_entry = next(k for k in kernels
                     if k["name"] == "window_attention_bwd")
    bwd_entry["max_rel_err"] = max(max(r["rel_err_dq_dk_dv"])
                                   for r in attn_bwd_rows)
    bwd_entry["max_rel_err_dbias"] = max(r["rel_err_dbias"]
                                         for r in attn_bwd_rows)
    bwd_entry["library_kernel"] = attn_bwd_rows[0]["library_kernel"]
    bwd_entry["library_bf16_mask_ms"] = attn_bwd_rows[0][
        "library_bf16_mask_ms"]
    bwd_entry["library_bf16_mask_kernel"] = attn_bwd_rows[0][
        "library_bf16_mask_kernel"]
    bwd_entry["bitwise_repeat"] = all(r["bitwise_repeat"]
                                      for r in attn_bwd_rows)
    bwd_entry["device_ms_pass_reduce_sdpa_sdpa_bf16_by_case"] = [
        [r["case"], r["device_ms_pass_reduce"], r["library_device_ms"],
         r["library_bf16_mask_device_ms"], r["library_bf16_mask_ms"]]
        for r in attn_bwd_rows]
    # talking heads: numbers at the headline shape (cait_s24_224 bs32,
    # the model's qkv entry), every shape beside them; launches from the
    # fine-tune run (the slice's training path), every path beside them
    head = th_rows[0]
    kernels.append({
        "name": "talking_heads", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/talking_heads.cu",
        "replaces": "vit_torch_tpu/ops/talking_heads.py:96, "
                    "vit_torch_tpu/ops/talking_heads.py:272",
        "launches": cait_paths["finetune"]["talking_heads"],
        "max_abs_err": max(r["max_abs_err"] for r in th_rows),
        "max_rel_err": max(r["max_rel_err"] for r in th_rows),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"],
        "library_kernel": head["library_kernel"], "shape": head["shape"],
        "launches_by_path": {p: c["talking_heads"]
                             for p, c in cait_paths.items()},
        "backward_recomputes_finetune":
            cait_paths["finetune"]["backward_recomputes"],
        "device_ms": head["device_ms"], "plan": head["plan"],
        "ptxas": th_ptxas,
        "ms_device_plain_bound_library_by_shape": [
            [r["shape"], r["entry"], r["ms"], r["device_ms"], r["plain_ms"],
             r["bound_ms"], r["library_ms"]] for r in th_rows],
        "finetune_step_ms": cait_steps["finetune"]["step_ms"],
        "lineareval_step_ms": cait_steps["lineareval"]["step_ms"],
        "eval_forward_ms": cait_steps["eval_forward"]["ms"]})
    # the fused attention blocks: numbers at the headline shapes
    # (dino_vits16 @224 bs64 for B3, dino_vitb8 @32 bs128 for B4), every
    # shape beside them; launches from the linear-eval run (B3) and the
    # fine-tune run (B4), every path beside them; whole steps with the
    # kernel on and off
    for kernel, by_shape, grads, line, paths, step_names in (
            ("attention_block", ab_rows, ab_grads[0], 132,
             ("lineareval", "serve", "lineareval_cached", "finetune"),
             ("vits16_lineareval_bs64", "vits16_lineareval_bs128",
              "vits16_finetune_bs64")),
            ("attention_block_packed", abp_rows, ab_grads[1], 282,
             ("small_finetune",), ("vitb8_32px_finetune_bs128",))):
        head = by_shape[0]
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "vit_torch_tpu_torch/csrc/attn_block.cu",
            "replaces": f"vit_torch_tpu/ops/attn_block.py:{line}",
            "launches": ab_paths[paths[0]][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in by_shape),
            "max_rel_err": max(r["max_rel_err"] for r in by_shape),
            "ms": head["ms"], "device_ms": head["device_ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "port_path_ms": head["port_path_ms"], "shape": head["shape"],
            "qkv_device_ms": head["qkv_device_ms"],
            "attn_kernel_device_ms": head["attn_kernel_device_ms"],
            "library_device_ms": head["library_device_ms"],
            "plan": head["plan"], "ptxas": ab_ptxas,
            "launches_by_path": {p: ab_paths[p][kernel] for p in paths},
            "ms_device_qkv_attn_plain_port_library_libdevice_bound_by_shape":
                [[r["shape"], r["ms"], r["device_ms"], r["qkv_device_ms"],
                  r["attn_kernel_device_ms"], r["plain_ms"],
                  r["port_path_ms"], r["library_ms"],
                  r["library_device_ms"], r["bound_ms"]]
                 for r in by_shape],
            "grad_max_rel_err": max(grads["grad_rel_err"]),
            "fwd_bwd_ms": grads["fwd_bwd_ms"],
            "port_path_fwd_bwd_ms": grads["port_path_fwd_bwd_ms"],
            "step_ms_kernel_on_off": {
                n: [[r["step_ms"] for r in ab_steps[n]["kernel_on"]],
                    [r["step_ms"] for r in ab_steps[n]["kernel_off"]]]
                for n in step_names}})
    # the fused MLP: numbers at the headline shape (DeiT-base bs32), every
    # shape beside them; launches from the fine-tune run (the slice's
    # headline path), every path beside them; whole steps with B12 on and
    # off.  Its library_ms is the port's default MLP: cuBLAS fc1, GELU,
    # cuBLAS fc2 (no one PyTorch call computes the MLP)
    head = mlp_rows[0]
    kernels.append({
        "name": "fused_mlp", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/fused_mlp.cu",
        "replaces": "vit_torch_tpu/ops/fused_mlp.py:92",
        "launches": deit_paths["finetune"]["fused_mlp"],
        "max_abs_err": max(r["max_abs_err"] for r in mlp_rows),
        "max_rel_err": max(r["max_rel_err"] for r in mlp_rows),
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "library": "F.linear -> F.gelu -> F.linear (cuBLAS)",
        "shape": head["shape"],
        "launches_by_path": {p: c["fused_mlp"] for p, c in deit_paths.items()},
        "ms_device_plain_library_bound_by_shape": [
            [r["shape"], r["ms"], r["device_ms"], r["plain_ms"],
             r["library_ms"], r["bound_ms"]] for r in mlp_rows],
        "plan_tflops_bound_share_by_shape": [
            [r["shape"], r["plan"], r["tflops"], r["library_tflops"],
             r["bound_share"]] for r in mlp_rows],
        "ptxas": mlp_ptxas,
        "layouts_chosen_rows_ms_by_rows": [
            [r["shape"], r["chosen_rows"], r["ms"]] for r in mlp_layouts],
        "grad_max_rel_err": max(mlp_grads["grad_rel_err"]),
        "fwd_bwd_ms": mlp_grads["fwd_bwd_ms"],
        "library_fwd_bwd_ms": mlp_grads["library_fwd_bwd_ms"],
        "step_ms_kernel_on_off": {
            n: [[r["step_ms"] for r in row["kernel_on"]],
                [r["step_ms"] for r in row["kernel_off"]]]
            for n, row in deit_steps.items()},
        "eval_forward_ms_kernel_on_off": [
            [r["eval_forward_ms"] for r in deit_steps[
                "deit_lineareval_bs32"][side]]
            for side in ("kernel_on", "kernel_off")],
        "xcit_launches_by_path": {p: c["fused_mlp"]
                                  for p, c in xcit_paths.items()},
        "xcit_shape_ms_device_plain_library_bound": [
            [r["shape"], r["ms"], r["device_ms"], r["plain_ms"],
             r["library_ms"], r["bound_ms"]] for r in (mlp_rows[2],
                                                       mlp_rows[7])],
        "xcit_step_ms_kernel_on_off": [
            [r["step_ms"] for r in xcit_steps[side]]
            for side in ("kernel_on", "kernel_off")]})
    # the flat window block: numbers at the headline case (swin_base_384
    # bs32 stage 1, shifted), every case beside them; launches from the
    # Swin linear eval with VITX_FUSED_SPATIAL=0
    head = flat_rows[0]
    kernels.append({
        "name": "window_block", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/window_gemm.cu",
        "replaces": "vit_torch_tpu/ops/window_block.py:200",
        "launches": swin_flat["window_block"],
        "max_abs_err": max(r["max_abs_err"] for r in flat_rows),
        "max_rel_err": max(r["max_rel_err"] for r in flat_rows),
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "case": head["case"],
        "launches_by_path": {"swin_flat_lineareval": swin_flat[
            "window_block"]},
        "ms_device_plain_bound_by_case": [
            [r["case"], r["ms"], r["device_ms"], r["plain_ms"],
             r["bound_ms"]] for r in flat_rows],
        "grad_max_rel_err": max(flat_grads["grad_rel_err"]),
        "fwd_bwd_ms": flat_grads["fwd_bwd_ms"]})
    # the conv families run no kernel of their own (XCiT's MLPs are B12's,
    # above): their paths, steps and the fold measurement in one line
    _say(json.dumps({"conv_families": {
        "xcit": {"arch": XCIT_ARCH, "launches_by_path": xcit_paths,
                 "step_ms_kernel_on_off": [
                     [r["step_ms"] for r in xcit_steps[side]]
                     for side in ("kernel_on", "kernel_off")]},
        "resnext": {"arch": RESNEXT_ARCH, "launches_by_path": resnext_paths,
                    "finetune_step_ms": resnext_steps["finetune_step"][
                        "step_ms"],
                    "eval_forward_ms_fold_on_off": [
                        [r["ms"] for r in resnext_steps[side]]
                        for side in ("eval_forward_fold_on",
                                     "eval_forward_fold_off")]}}}))
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
