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
   (where there is one): the flash kernels at the dino_vitb8 shapes; the
   window-attention core (row 5), its backward (row 6) and the window
   blocks B8 and B9 (rows 8 and 9) at all four stages of swin_base_384
   bs32, shifted and unshifted, at swin_tiny's window-7 stage 1 and at a
   ragged small shape; the gradients of B8 and B9 against autograd
   through their plain versions at the headline, window-7 and ragged
   shapes; the talking-heads kernel (rows 10 and 11) at the attention
   shapes of cait_s24_224 bs32, xxs24, s24_384, m36_384, m48_448 and a
   ragged one through the model's qkv entry, and the headline through
   the (B, N, C) entry; the fused MLP (row 12) at DeiT-base, dino_vitb8
   and cait_s24_224 bs32, swin_base_384 stage 1 and a ragged shape, with
   its gradients at the headline; the flat window block (row 7) at the
   Swin block cases, with its gradients at the headline;
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
   ``cli.main`` (24 kernel launches per backbone forward, no flash or
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
   + flash + cuBLAS) and cuBLAS + SDPA; exports and serves dino_vits16
   @224 over HTTP with B3 on (buckets 1/8/64, launches = 12 x
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
11. prints one JSON line with each kernel's numbers, then the card's name
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
ATTN_SHAPES = [(32, 12, 785, 64), (8, 12, 197, 64), (2, 2, 65, 32),
               (1, 1, 1, 64)]
# the dino_vitb8 finetune shapes at 224 px bs32 and 32 px bs128, and small
# ragged ones
BWD_SHAPES = [(32, 12, 785, 64), (128, 12, 17, 64), (8, 12, 197, 64),
              (2, 2, 65, 32), (1, 1, 1, 64)]
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
# headline), dino_vitb8 @224 bs32, cait_s24_224 bs32, swin_base_384 stage 1
# bs32 (the byte-bound case) and a ragged T with out != C and no biases
MLP_SHAPES = [(6336, 768, 3072, 768, True), (25120, 768, 3072, 768, True),
              (6272, 384, 1536, 384, True), (294912, 128, 512, 128, True),
              (1000, 256, 1024, 520, False)]
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
    against the plain logsumexp, and times the backward kernel, the plain
    backward, SDPA's backward and the forward with the LSE written."""
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
    ms = _time_ms(lambda: fa.flash_attention_bwd(
        q, k, v, o, lse, do, scale=scale, dq=dq, dk=dk, dv=dv),
        iters=20 if big else 100)
    plain_ms = _time_ms(lambda: fa.flash_attention_bwd_reference(
        q, k, v, do, scale=scale), iters=3 if big else 20)
    qs, ks, vs = (x.contiguous().requires_grad_(True) for x in (q, k, v))
    dos = do.contiguous()
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        o_lib, (qs, ks, vs), dos, retain_graph=True),
        iters=20 if big else 100)
    fwd_lse_ms = _time_ms(lambda: fa.flash_attention_fwd(
        q, k, v, scale=scale, out=o, return_lse=True),
        iters=20 if big else 100)
    bound_ms, bound_by = _bwd_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "rel_err_dq_dk_dv": errs,
           "max_abs_err": abs_err,
           "max_abs_err_lse": lse_err, "ms": ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by, "fwd_with_lse_ms": fwd_lse_ms,
           "fwd_bound_ms": _attention_bound_ms(B, H, N, D)[0]}
    _say("kernel check flash_attention_bwd", json.dumps(row))
    return row


def check_flash_kernel(shape, seed):
    """Kernel vs plain version on one shape, through both entries: the
    (B, N, H, D) one fed as the model feeds it (q, k, v strided views into
    one (B, N, 3, H, D) qkv tensor) and the (B, H, N, D) one on contiguous
    inputs.  Times the first, as the serving path calls it."""
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
    ms = _time_ms(lambda: fa.flash_attention(q, k, v, scale=scale),
                  iters=20 if big else 100)
    plain_ms = _time_ms(lambda: fa.flash_attention_bhnd_reference(
        qt, kt, vt, scale=scale), iters=5 if big else 20)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, scale=scale), iters=20 if big else 100)
    bound_ms, bound_by = _attention_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
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
    ms = _time_ms(lambda: wa.window_attention(q, k, v, bias, mask), iters=20)
    plain_ms = _time_ms(lambda: wa.window_attention_reference(
        q, k, v, bias, mask), iters=3)
    qs, ks, vs = (x.reshape(B, nW, N, heads, 32).transpose(2, 3).contiguous()
                  for x in (q, k, v))
    add = bias[None, None] + (0 if mask is None else mask[None, :, None])
    add = add.to(torch.bfloat16).expand(B, nW, heads, N, N)
    library_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=add, scale=32 ** -0.5), iters=20)
    bound_ms, bound_by = _attention_bound_ms(Bn, heads, N, 32)
    row = {"case": list(case), "shape": [Bn, N, heads, 32],
           "masked": mask is not None, "max_abs_err": err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by}
    _say("kernel check window_attention", json.dumps(row))
    return row


def _library_backend(fn) -> str:
    """The kernel that takes most device time in one call of ``fn``: the
    backend PyTorch picked."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not evs:
        return "not measured"
    return max(evs, key=lambda e: e.self_device_time_total).key[:80]


def _device_ms(fn, kernel, iters: int = 10) -> float:
    """Mean device time per call of ``fn`` spent in the kernels whose name
    holds ``kernel`` (a name, or a tuple of names), from torch.profiler:
    the kernel's own time where the CUDA-event time of a loop of calls is
    set by the host's launch rate."""
    names = (kernel,) if isinstance(kernel, str) else kernel
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and any(n in e.key for n in names)) / 1e3 / iters


def check_window_attention_bwd(case, seed):
    """The window-attention backward (row 6) vs its plain version on the
    windows of one block case, fed as the B8 Function feeds it: q, k, v
    strided views into one window-major qkv tensor, through
    ``window_attention_qkv``'s autograd Function, whose backward writes one
    (Bn, N, 3, H, D) gradient; the fp32 bias and the block's real mask.
    Times the kernel, the plain backward and SDPA's backward with the
    float ``bias + mask`` as ``attn_mask`` (over (B, nW, H, N, D), as
    row 5 times its forward), and names the kernel SDPA ran."""
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
    torch.cuda.synchronize()
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
            and torch.isfinite(dbias).all()):
        raise AssertionError(f"window_attention_bwd {case}: dq/dk/dv error "
                             f"relative to max|plain| {errs} (limit "
                             f"{BWD_RTOL}), dbias {db_err} (limit "
                             f"{WINDOW_DBIAS_RTOL})")
    dq, dk, dv = dqkv.unbind(2)
    ms = _time_ms(lambda: wa.window_attention_bwd(
        q, k, v, bias, mask, dout, dq=dq, dk=dk, dv=dv), iters=20)
    plain_ms = _time_ms(lambda: wa.window_attention_bwd_reference(
        q, k, v, bias, mask, dout), iters=3)
    qs, ks, vs = (x.reshape(B, nW, N, heads, 32).transpose(2, 3)
                  .contiguous().requires_grad_(True) for x in (q, k, v))
    dos = dout.reshape(B, nW, N, heads, 32).transpose(2, 3).contiguous()
    add = bias[None, None] + (0 if mask is None else mask[None, :, None])
    add = add.to(torch.bfloat16).expand(B, nW, heads, N, N)
    o_lib = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=add,
                                           scale=32 ** -0.5)

    def lib():
        return torch.autograd.grad(o_lib, (qs, ks, vs), dos,
                                   retain_graph=True)

    library_ms = _time_ms(lib, iters=20)
    backend = _library_backend(lib) if seed == 0 else None
    del o_lib
    bound_ms, bound_by = _window_bwd_bound_ms(Bn, heads, N, 32)
    row = {"case": list(case), "shape": [Bn, N, heads, 32],
           "masked": mask is not None, "rel_err_dq_dk_dv": errs,
           "rel_err_dbias": db_err, "max_abs_err": abs_err, "ms": ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "library_kernel": backend, "bound_ms": bound_ms,
           "bound_by": bound_by}
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


def check_window_blocks(case, seed):
    """B8 (``window_block_spatial``, row 8) and B9
    (``window_block_full_spatial``, row 9) vs their plain versions on one
    block case, the shift folded into the kernels' addressing and rolled by
    the plain versions; times each chain and each plain version."""
    import torch
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift = case
    d = _block_inputs(case, seed)
    kw = dict(num_heads=C // 32, window=w, shift=shift)
    b8 = (d["x"], *d["qkv"], d["bias"], d["mask"], *d["proj"])
    b9 = (d["x"], d["ln1"], d["qkv"], d["bias"], d["mask"], d["proj"],
          d["ln2"], d["fc1"], d["fc2"])
    rows = {}
    for name, fn, ref_fn, args, full in (
            ("window_block_spatial", wb.window_block_spatial,
             wb.window_block_spatial_reference, b8, False),
            ("window_block_full_spatial", wb.window_block_full_spatial,
             wb.window_block_full_spatial_reference, b9, True)):
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
        plain_ms = _time_ms(lambda: ref_fn(*args, **kw), iters=3)
        bound_ms, bound_by = _block_bound_ms(case, full)
        rows[name] = {"case": list(case), "max_abs_err": abs_err,
                      "max_rel_err": rel, "ms": ms, "plain_ms": plain_ms,
                      "library_ms": None, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        _say(f"kernel check {name}", json.dumps(rows[name]))
    return rows


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
    calls, ``device_ms`` the kernel's own time from the profiler (the two
    part where the host's launch rate sets the loop)."""
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
    ms = _time_ms(run, iters=20 if big else 100)
    device_ms = _device_ms(run, "talking_heads_fwd_kernel")
    plain_ms = _time_ms(lambda: th.talking_heads_reference(
        q, k, v, *tables, scale=scale), iters=3 if big else 20)
    library_ms = _time_ms(lib, iters=10 if big else 50)
    bound_ms, bound_by = _th_bound_ms(B, H, N, D)
    row = {"shape": list(shape), "entry": "bnc" if bnc else "qkv",
           "max_abs_err": abs_err, "max_rel_err": rel, "ms": ms,
           "device_ms": device_ms,
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
        return "window_gemm"        # the B8 / B9 products, B3 / B4's qkv
    if "attn_block_kernel" in name:
        return "attention_block"    # B3 / B4 attention and projection
    if "talking_heads_fwd_kernel" in name:
        return "talking_heads"
    if "fused_mlp_kernel" in name:
        return "fused_mlp"
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
                     buckets: str = BUCKETS):
    """Export → BundleServer on cuda → concurrent HTTP requests; prints
    the serving numbers and returns the launch counts of the HTTP run.
    Each of ``kernels`` must launch once per layer per dispatch, and no
    other kernel at all.  ``plain()`` is a context that patches the plain
    versions in; the logits of the two must agree within ``logits_tol``
    (relative to max |plain logit| when ``relative``).  ``prepare(state)``
    may edit the exported state dict in place before the server loads
    it.  The last of ``buckets`` is the batch of the batched request and
    of the served img/s."""
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
        depth = _depth(server.model.model.backbone)
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
        resized = resize_images(batch, image_size)
        kernel_logits = server.model.predict(resized)
        with plain():
            plain_logits = server.model.predict(resized)
        err = float(np.abs(kernel_logits - plain_logits).max())
        err_http = float(np.abs(http_big - plain_logits).max())
        max_logit = float(np.abs(plain_logits).max())
        _say(f"logits {arch} kernel vs plain: max abs err {err:.5f} "
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


def _plain_attention():
    from vit_torch_tpu_torch.ops import attention as attention_mod
    return mock.patch.object(attention_mod, "flash_attention_qkv", _plain_qkv)


def _counters():
    """Every kernel wrapper, by the name it has in the kernels line."""
    from vit_torch_tpu_torch.ops import attn_block as ab
    from vit_torch_tpu_torch.ops import flash_attention as fa
    from vit_torch_tpu_torch.ops import fused_mlp as fm
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
            "window_block": wb.window_block}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _want(**launches):
    """Launch counts with every kernel not named at 0."""
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


def profile_train_step(trainer, batch, iters: int = 2):
    """Device time of the train step by kernel group and the device's idle
    share of the host-clock window, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            trainer.train_step(*batch)
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0) / iters
    return _device_groups(prof, iters, window_ms, top_n=10)


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
    t = _time_train_steps(trainer, batch, iters)
    step_ms, per_step = t["step_ms"], t["launches_per_step"]
    fwd_flops = swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    zm.model.eval()
    x = trainer.eval_transform(batch[0])
    _reset_counts()
    with torch.no_grad():
        eval_ms = _time_ms(lambda: zm.model(x), iters=10)
    eval_counts = _read_counts()
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
    t = _time_train_steps(trainer, batch, iters)
    step_ms, per_step = t["step_ms"], t["launches_per_step"]
    step_flops = 3 * swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    row = {"arch": SWIN_ARCH, "image_size": SWIN_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "finetune_step_ms": step_ms,
           "host_step_ms": t["host_step_ms"],
           "finetune_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step, "peak_mem_gb": t["peak_mem_gb"],
           "profile": t["profile"]}
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


def check_attention_block(shape, seed, packed: bool = False):
    """B3 (row 3) or B4 (row 4, with its qkv output) vs the plain version on
    one (B, N, C, heads) shape; times the chain on CUDA events and its two
    kernels' device time from the profiler, the plain version, the port's
    unfused path (cuBLAS + flash + cuBLAS) and the library's (cuBLAS +
    SDPA)."""
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
    ms = _time_ms(run, iters=50)
    device_ms = _device_ms(run, ("attn_block_kernel", "window_gemm_kernel"))
    attn_device_ms = _device_ms(run, "attn_block_kernel")
    plain_ms = _time_ms(plain, iters=5)
    port_ms = _time_ms(lambda: _port_path(*args, H, scale), iters=50)
    library_ms = _time_ms(lambda: _library_block(*args, H, scale), iters=50)
    bound_ms, bound_by = _ab_bound_ms(B, N, C, packed)
    row = {"shape": list(shape), "max_abs_err": abs_err, "max_rel_err": rel,
           "qkv_max_rel_err": qkv_rel if packed else None, "ms": ms,
           "device_ms": device_ms, "attn_kernel_device_ms": attn_device_ms,
           "plain_ms": plain_ms, "port_path_ms": port_ms,
           "library_ms": library_ms, "bound_ms": bound_ms,
           "bound_by": bound_by}
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
    row = {"shape": [T, C, Hd, Co], "biases": bias, "max_abs_err": abs_err,
           "max_rel_err": rel, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "slabs": -(-Co // 384)}
    _say("kernel check fused_mlp", json.dumps(row))
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
        _say(f"ptxas {kernel}: " + " | ".join(
            line.split(":", 1)[-1].strip() for line in log.splitlines()
            if "Compiling entry" in line or "registers" in line
            or "spill" in line))

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
        "max_abs_err_lse": max(r["max_abs_err_lse"] for r in bwd_rows)}, {
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
        "bound_ms_32px_bs128": bwd_rows[1]["bound_ms"]}]
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
            "launches_by_path": {p: c[kernel]
                                 for p, c in swin_paths.items()},
            "ms_plain_bound_by_case": [
                [r["case"], r["ms"], r["plain_ms"], r["bound_ms"]]
                for r in by_case]})
    kernels[-1]["lineareval_step_ms"] = swin_step["lineareval_step_ms"]
    kernels[-1]["eval_forward_ms"] = swin_step["eval_forward_ms"]
    kernels[-1]["finetune_step_ms"] = swin_ft_step["finetune_step_ms"]
    bwd_entry = next(k for k in kernels
                     if k["name"] == "window_attention_bwd")
    bwd_entry["max_rel_err"] = max(max(r["rel_err_dq_dk_dv"])
                                   for r in attn_bwd_rows)
    bwd_entry["max_rel_err_dbias"] = max(r["rel_err_dbias"]
                                         for r in attn_bwd_rows)
    bwd_entry["library_kernel"] = attn_bwd_rows[0]["library_kernel"]
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
        "device_ms": head["device_ms"],
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
            "launches_by_path": {p: ab_paths[p][kernel] for p in paths},
            "ms_device_plain_port_library_bound_by_shape": [
                [r["shape"], r["ms"], r["device_ms"], r["plain_ms"],
                 r["port_path_ms"], r["library_ms"], r["bound_ms"]]
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
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
