"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the device and its power limit;
2. builds every CUDA kernel (``_build.KERNELS``: the flash-attention
   forward and backward, the Swin window-attention core forward and
   backward, the window GEMM, talking heads, the fused attention block,
   the fused MLP, W8A8's row quantisation and int8 product, and DETR's
   auction matcher) from the sources in the checkout
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
   the headline; then every kernel a tensor-parallel rank launches at
   the widths the parallel modes give it (``tp_width_checks``): flash
   forward and backward at 6 of dino_vitb8's 12 heads (model=2) and at
   16 and 8 images (data=2, pipe=2's microbatches), B8 over a rank's
   heads of swin_base_384 at bs8 and bs4 (stages 1-4 at model=2, stage 1
   at model=4: one head) with its two window-GEMM launches alone at their
   T, K and N
   and its gradients through B6, the core and B6 at those widths, B12
   over half of DeiT-base's hidden columns with a zero output bias;
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
12. the training life cycle and the data extras (no kernel of their own;
   their ViT steps run the flash pair, counted on every path):
   fine-tunes dino_vitb8 @224 bs32 for two one-batch epochs through
   ``cli.main`` with ``--ckpt_dir --save_every 1 --export_bundle`` (the
   random crop and flip off), checks the checkpoint layout, holds the
   latest checkpoint bitwise against the trainer's state in memory and
   times its save and restore, redoes epoch 1 from the epoch-0 checkpoint
   through ``--resume`` and holds its parameters against the unbroken
   run's; serves the exported bundle (one 32-image request, logits
   against the CPU in fp32); holds each of the 14 AutoAugment ops at bs32
   @224 against the same op on the CPU with the same draws, runs one
   synthetic epoch with ``--aug_auto imagenet`` and times the step with
   AutoAugment off, on, on, off; writes a synthetic tire ImageFolder,
   trains dino_vits16 @224 bs32 on it (setting 0, 7 channels) with and
   without ``--aug_auto`` and holds device LBP against host LBP (no code
   may differ);
13. W8A8 (``csrc/w8a8.cu``): holds Q1 (row quantisation; bit for bit)
   and Q2 (the int8 product; within W8A8_ULPS) against their plain
   versions at dino_vitb8 @224 bs8 and bs32's qkv, proj, fc1 and fc2,
   the Swin MLPs W8A8 runs at bs8 (stage 1's fc1 and fc2, stage 4's fc1)
   and a ragged shape, timed beside their bounds, the plain versions,
   ``torch._int_mm`` plus the same rescale and the bf16 ``F.linear``,
   with Q1's share of its bound and plans (threads a row, units a
   thread, passes, block, grid) and Q2's plan (tile, stages, schedule) in
   each row (``kernel check w8a8``; the source passes the ptxas gate);
   exports
   dino_vitb8 @224 through ``cli.export --w8a8`` and serves it over HTTP
   as in 4 (per dispatch 48 Q1 and 48 Q2 launches and 12 flash, the
   logits against the plain versions), then the fp bundle of the same
   weights: bundle bytes, cosine and top-1 agreement of the two, their
   predict times in turns (``w8a8_serve``); runs one full-width bs8 eval
   forward of deit_base_distilled, cait_s24_224, xcit_small_24_p16 and
   swin_base_384 with ``VITX_W8A8`` off and on (every QLinear one Q2 and
   two Q1 launches, Swin off B9, cosine above W8A8_MIN_COSINE:
   ``w8a8_families``);
14. DETR (ROADMAP A10a): holds the flash pair with a key length of its
   own against the plain versions at DETR's shapes (the decoder's
   cross-attention, both self-attentions, a ragged memory, Nq > Nk),
   timed beside SDPA forward and backward (``kernel check
   flash_attention_cross``); writes a synthetic COCO set at 512 px and
   trains full-width DETR over Swin-T at bs8 for one epoch and evaluates
   its bbox AP through ``vit_torch_tpu_torch.cli.coco`` (18 flash
   forward and 18 backward launches and 12 B8 a step: ``detr_train``);
   times and profiles the step with the host matcher's share
   (``detr_step``); holds one bs8 step on the kernels and one on the
   plain versions against the fp32 step (``detr_step_vs_plain``); runs an
   eval forward with W8A8 off and on (``detr_w8a8``); prints a ``detr``
   summary line;
15. Faster R-CNN and Keypoint R-CNN (ROADMAP A10b): writes a synthetic
   COCO set with keypoints at 512 px and trains each full-width model
   (FPN 256, 1000 pre-NMS and 256 proposals, 100 detections; the
   keypoint head 8 x 512 convs at 14 x 14 over 128 RoIs) for one epoch
   at bs8 and evaluates it through ``cli.coco --head faster_rcnn``: over
   resnext50_32x4d (no hand kernel: ``frcnn_train``), over Swin-T (B8 and
   the core forward, B6 backward, 12 a pass: ``frcnn_swin_train``) and
   with ``--keypoints`` (``kprcnn_train``, the keypoint AP); times and
   profiles the ResNeXt step with and without keypoints, the padded NMS
   loop's launches and share, peak memory, and whether the step reads the
   device before its loss (``frcnn_step``); holds the Swin route's FPN
   maps, RPN outputs and backbone gradients on the kernels against the
   plain versions (``frcnn_vs_plain``); runs the eval forward with W8A8
   off and on (Q1 and Q2 at the box head's 2048 x 12,544 -> 1024 and
   2048 x 1024 -> 1024, each held against its plain versions:
   ``frcnn_w8a8``); prints a ``frcnn`` summary line;
16. DETR instance masks and panoptic (ROADMAP A10c): on the DETR
   phase's synthetic COCO set (its polygons the gt masks) trains
   full-width DETRSegm (8 mask heads) over Swin-T at bs8 for one epoch
   and evaluates bbox and segm AP and PQ through ``cli.coco --masks``
   (the flash pair, B8, the core and B6 launched as in DETR:
   ``segm_train``); times and profiles the step with the mask branch's
   own time and share, peak memory, the host matcher and the step's
   synchronising calls (``segm_step``); holds one bs8 step on the
   kernels and one on the plain versions against the fp32 step: the mask
   logits, the mask losses, the mask branch's and backbone's gradients
   (``segm_vs_plain``); scores one model's predictions with PQ and
   without, whose segm APs must agree exactly, with their host-time
   split and the copied mask bytes (``segm_eval``); writes a synthetic panoptic split at 512 px and runs
   ``cli.coco --panoptic_root`` for one epoch (``panoptic_train``: PQ,
   SQ, RQ); runs the eval forward with W8A8 off and on (``segm_w8a8``:
   the cosines of the logits and of the mask logits, Q1/Q2 launches);
   prints a ``segm`` summary line;
17. DETR's device matcher and the rest of detection's life cycle (ROADMAP
   A10d), on the DETR phase's synthetic set: holds the auction kernel
   (``csrc/auction.cu``) against its plain version at (6, 8, 100, 64) on
   random costs over non-prefix masks, integer costs full of ties, more
   valid gts than queries, no valid gt and the costs of a real DETR step
   (assignments equal, a permutation on the valid gts, the total within
   n_valid · ε of the exact assignment), timed on events and from the
   profiler with its iterations (``kernel check auction``); times the
   device-matcher step beside the host-matcher step (busy, idle, peak
   memory, launches, no device read before the loss on the device route:
   ``detr_device_step``) and holds the bf16 device step against the fp32
   one (``detr_device_step_vs_plain``); trains through ``cli.coco
   --matcher device --scan 4 --ckpt_dir``, resumes epoch 1 with
   ``--export_bundle`` (the restored state bitwise the saved one), exports
   again under ``VITX_W8A8=1`` (``detr_scan_resume_bundle``: epoch
   seconds, one read a chunk, checkpoint bytes, save and restore
   seconds), serves the bundle over HTTP to a burst of 16 pictures at
   varied aspect ratios and checks the replies against
   ``trainer.predict`` and the W8A8 bundle's Q1/Q2 launches and cosine
   (``detr_serve``); runs ``cli.coco --head faster_rcnn --keypoints --scan
   4 --export_bundle`` and serves the Keypoint R-CNN bundle
   (``frcnn_scan_bundle``); prints an ``a10d`` summary line;
18. parallelism (ROADMAP A8), dino_vitb8 @224 bs32 through ``cli.main``
   on the resume phase's one-batch epoch: ``--mesh data=1`` over a
   world-1 NCCL group (``mesh_dp_world1``: the flash pair's launches the
   plain trainer's, the losses and weights within the resume phase's
   bounds of the same seed's run without ``--mesh``, the step's ms both
   ways) and the same with ``--fsdp`` (``mesh_fsdp_world1``: over one
   rank FSDP shards nothing, as in the JAX package, and the peak memory
   both ways); then one spawn of two ranks on ``cuda:0`` over gloo (two
   local ranks on one card choose it: NCCL refuses them; gloo's
   point-to-point transfers of CUDA tensors are staged through host
   memory) runs each mode on a fresh group: ``cli.main --mesh model=2
   --ckpt_dir``, whose checkpoint must load into a single-process model
   equal to the rank's gathered weights, and whose losses and checkpoint
   are held to the resume phase's bounds of the run without ``--mesh``
   (``tp_vit_cli_two_ranks_one_card``),
   then three steps of the global bs32 at data=2
   (``dp_two_ranks_one_card``, with the gradient all-reduce's ms),
   model=2, seq=2 (the ring) and pipe=2 (4 microbatches) and three
   swin_base_384 bs4 steps at model=2, each against its single-process
   steps within the bf16 step bounds, each rank's launches against those
   the block counts give (``<mode>_two_ranks_one_card``: losses, each
   parameter's relative gradient distance, step ms, the collectives'
   calls and bytes a step); prints an ``a8`` summary line and each phase
   group's seconds (``phase_seconds``);
19. prints one JSON line with each kernel's numbers (with the parallel
   modes' launches and the ``tp_widths`` rows), then the card's name
   and power limit from nvidia-smi, then
   ``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.

Any failure raises and exits non-zero; without a CUDA device it exits
non-zero before printing any result.
"""

from __future__ import annotations

import base64
import gc
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

# the training life cycle (ROADMAP A6, A9's --export_bundle): dino_vitb8
# @224 bs32 through cli.main on the per-step path with one batch an epoch
# (--scan 0, 32 train and 32 val samples), the random augmentation off
# (crop pad 0, no flip) and no dropout or drop-path (dino_vitb8 has none),
# so that a resume's shuffle restart changes only the order of the
# batch's rows
RESUME_LR = 1e-4
RESUME_ARGS = ["--dataset", "synthetic", "--arch", ARCH, "--image_size",
               str(IMAGE_SIZE), "--bs", str(TRAIN_BS), "--opt", "adamw",
               "--lr", str(RESUME_LR), "--fc", "512", "--scan", "0",
               "--limit_train", str(TRAIN_BS), "--limit_test",
               str(TRAIN_BS)]
# the resumed epoch 1 against the unbroken run's epoch 1, both from the
# same epoch-0 checkpoint: the rows summed in another order and the flash
# backward's dQ added by red.global.add in an order that varies between
# runs (ROADMAP §C) give gradients apart by rounding, not bitwise.  One
# AdamW step moves an element by about lr at most, so no element may
# differ by more than 4 lr, and the two epochs' updates must agree to 10%
# of the update's norm (a lost optimizer state or weight fails both)
RESUME_ATOL = 4 * RESUME_LR
RESUME_UPDATE_RTOL = 0.1
# AutoAugment's ops on the card against the same op on the CPU with the
# same draws (bs32 @224): a warp's sample coordinate within rounding of a
# pixel boundary (cos/sin and the affine sums rounded apart on the two
# devices) lands on the neighbouring pixel, so up to 1% of a warp's pixels
# may differ by more than one level; the other ops, none
AA_WARPS = ("shearX", "shearY", "translateX", "translateY", "rotate")
AA_WARP_SHARE = 1e-2
# the tire phase: a synthetic ImageFolder of two classes of 20 PNGs of four
# sizes (32 train and 8 test images at test ratio 0.2), tire setting 0
# (r, g, b and four LBP maps, 7 channels), dino_vits16 @224 bs32
TIRE_PER_CLASS = 20
TIRE_SIZES = [(240, 320), (300, 300), (180, 260), (400, 280)]
TIRE_ARGS = ["--dataset", "tire", "--arch", VITS_ARCH, "--image_size",
             str(VITS_SIZE), "--tire_settings", "0", "--bs", str(TRAIN_BS),
             "--epoch", "1", "--opt", "adamw", "--lr", "1e-4", "--fc", "512"]
# W8A8 (csrc/w8a8.cu): Q1 (row quantisation) must equal its plain version
# bit for bit; Q2 (int8 product) may differ from its plain version by one
# ulp of its output (both round each step once; nvcc contracts nothing).
# The shapes: dino_vitb8 @224 (785 tokens) at bs8 and bs32, its qkv, proj,
# fc1 and fc2 (T, K, N); the Swin MLPs that W8A8 runs at W8A8_FAMILY_BS
# (swin_base_384, 96 x 96 and 12 x 12 tokens): stage 1's fc1 (one k-step,
# the most epilogue-bound product) and fc2, stage 4's fc1; then a partial
# row tile, a K tail and a partial column tile
W8A8_ULPS = 1
W8A8_SHAPES = [(785 * bs, K, N) for bs in (8, 32)
               for K, N in ((768, 2304), (768, 768), (768, 3072),
                            (3072, 768))] + [
    (8 * 96 * 96, 128, 512), (8 * 96 * 96, 512, 128),
    (8 * 12 * 12, 1024, 4096), (203, 784, 200)]
# served W8A8 logits against the plain versions on the card (flash's
# rounding can move a code by one step, so not bit for bit): max abs err
# relative to max |plain logit|; the W8A8 bundle's logits against the fp
# bundle's (same weights): cosine above the JAX test's 0.99
# (tests/test_quant.py:test_vit_logits_agreement)
W8A8_LOGITS_RTOL = 5e-2
W8A8_MIN_COSINE = 0.99
# every transformer family's eval forward at full width, W8A8 on and off
W8A8_FAMILIES = [(DEIT_ARCH, DEIT_SIZE), (CAIT_ARCH, CAIT_SIZE),
                 (XCIT_ARCH, XCIT_SIZE), (SWIN_ARCH, SWIN_SIZE)]
W8A8_FAMILY_BS = 8
H100_INT8_OPS = 1979e12           # dense tensor-core peak, SXM
# DETR (ROADMAP A10a): the flash kernels with a key length of their own,
# (B, H, Nq, Nk, D) at Swin-T 512 px bs8 (a 16 x 16 memory, hidden 256, 8
# heads): the decoder's cross-attention, the encoder's and the decoder's
# self-attention, a ragged memory and 300 queries over 256 keys (Nq > Nk)
DETR_FLASH_SHAPES = [(8, 8, 100, 256, 32), (8, 8, 256, 256, 32),
                     (8, 8, 100, 100, 32), (3, 8, 100, 391, 32),
                     (8, 8, 300, 256, 32)]
DETR_BACKBONE, DETR_SIZE, DETR_BS = "swin_tiny_patch4_window7_224", 512, 8
# synthetic COCO pictures at 512 px; the validation split cut to 16 (two
# eval batches) to keep the run inside its time limit
DETR_TRAIN_N, DETR_VAL_N = 64, 16
DETR_LAYERS = 6                        # encoder and decoder layers each
# a forward runs 6 encoder self-, 6 decoder self- and 6 cross-attentions
DETR_FLASH = 3 * DETR_LAYERS
SWIN_T_DEPTH = 12                      # every block pads at 512 px: B8
# the bs8 DETR step against the fp32 step (compare_detr_step_with_plain):
# the loss relative to the fp32 loss (the classifiers' STEP_LOSS_ATOL is
# 2e-2 on a loss near ln 10, about 1%); the kernel step's gradients that
# bf16 can compute at all (the plain bf16 step within STEP_GRAD_RTOL of
# fp32): their median within STEP_GRAD_RTOL, none past DETR_STEP_GRAD_MAX,
# the plain step's bound and the kernels' own added
DETR_STEP_LOSS_RTOL = 1e-2
DETR_STEP_GRAD_MAX = 2 * STEP_GRAD_RTOL
DETR_ARGS = ["--backbone", DETR_BACKBONE, "--image_size", str(DETR_SIZE),
             "--bs", str(DETR_BS), "--epochs", "1", "--no_initial_eval",
             "--num_queries", "100", "--hidden_dim", "256", "--enc_layers",
             str(DETR_LAYERS), "--dec_layers", str(DETR_LAYERS)]
# Faster R-CNN / Keypoint R-CNN (ROADMAP A10b) at the JAX CLI's full
# settings, 512 px bs8, on a synthetic COCO set with keypoints
FRCNN_SIZE, FRCNN_BS = 512, 8
FRCNN_TRAIN_N, FRCNN_VAL_N = 64, 16
FRCNN_BACKBONE = RESNEXT_ARCH
FRCNN_ARGS = ["--head", "faster_rcnn", "--image_size", str(FRCNN_SIZE),
              "--bs", str(FRCNN_BS), "--epochs", "1", "--no_initial_eval"]
# the box head's two QLinear products in the bs8 eval forward: 8 x 256
# RoIs, box_fc1 over 7 x 7 x 256 RoI features, box_fc2
FRCNN_W8A8_SHAPES = [(FRCNN_BS * 256, 7 * 7 * 256, 1024),
                     (FRCNN_BS * 256, 1024, 1024)]
# the Swin route's FPN maps and RPN outputs, kernels vs plain versions
# through the same bf16 model (max |diff| relative to max |plain|, as the
# served Swin logits are held), and its backbone gradients under a fixed
# upstream gradient (relative norm, whole and per parameter's median, the
# classifiers' STEP_GRAD_RTOL)
FRCNN_PLAIN_RTOL = SWIN_LOGITS_RTOL
# DETR instance masks and panoptic (ROADMAP A10c): DETRSegm (the JAX CLI's
# 8 mask heads) with DETR's settings on the DETR phases' synthetic COCO set
# (its polygons are the gt masks), and a synthetic panoptic split at 512
# px, cut to 16 + 8 pictures to fit the time limit
SEGM_ARGS = DETR_ARGS + ["--masks"]
PAN_TRAIN_N, PAN_VAL_N = 16, 8
# the bs8 DETRSegm step against the fp32 step (compare_segm_step_with_plain):
# the mean focal and dice losses of the matched masks, bf16 logits through
# the conv head against fp32 ones, within 2%; the pred_masks logits and the
# mask branch's and backbone's gradients (relative norm of the group)
# within the classifiers' STEP_GRAD_RTOL or twice the plain bf16 step's
# own distance from fp32, whichever is larger
SEGM_LOSS_RTOL = 2e-2
SEGM_RTOL = STEP_GRAD_RTOL
# the device matcher (ROADMAP A10d): the auction at DETR's (L, B, Q, N) =
# (6, 8, 100, 64) (--max_boxes 64); chunks of SCAN_K steps; served
# detections against trainer.predict on the same letterboxed batch: the
# served-logits bound on the scores (5e-2 of max |score|), boxes within
# 5e-2 of the image size; SERVE_BURST one-picture requests at once
AUCTION_Q, AUCTION_N = 100, 64
SCAN_K = 4
SERVE_SCORE_RTOL = LOGITS_ATOL
SERVE_BOX_RTOL = 5e-2
SERVE_BURST = 16


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
    whole, split = _once_a_call(run, FLASH_BWD_KERNELS)
    if not whole:
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
    whole, ((device_ms, seen),) = _once_a_call(run, ("flash_fwd_kernel",))
    if not whole:
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
           "bound_share": None if device_ms is None else bound_ms / device_ms,
           "plan": plan._asdict(),
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


def _once_a_call(fn, kernels, tries: int = 3):
    """(whole, times): ``_device_times`` of ``fn`` over ``kernels``, whole
    when the profiler saw every entry once a call with a positive time.
    The card's profiler now and then drops an event from a pass (a kernel
    read 0.9 times a call over 10 calls), so a pass that is not whole is
    made again, up to ``tries`` passes; the last pass's times are
    returned either way."""
    for _ in range(tries):
        times = _device_times(fn, kernels)
        if all(t > 0 and n == 1 for t, n in times):
            return True, times
    return False, times


def _device_ms(fn, kernel, iters: int = 10, tries: int = 3):
    """Mean device time per call of ``fn`` spent in the kernels whose name
    holds ``kernel`` (a name, or a tuple of names).  A pass in which the
    profiler recorded none of them is made again, up to ``tries`` passes
    (as in ``_once_a_call``); then the time reads None ("not
    measured")."""
    for _ in range(tries):
        ms = _device_times(fn, (kernel,), iters)[0][0]
        if ms > 0:
            return ms
    return None


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
    whole, ((pass_ms, pass_n), (reduce_ms, reduce_n)) = _once_a_call(
        run, ("window_attn_bwd_kernel", "dbias_reduce_kernel"))
    device_ms = pass_ms + reduce_ms if whole else None
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
           "device_ms": device_ms,
           "device_ms_pass_reduce": [pass_ms, reduce_ms] if whole else None,
           "launches_per_call_pass_reduce": [pass_n, reduce_n],
           "plain_ms": plain_ms, "library_ms": libs["grad_bias"]["ms"],
           "library_kernel": libs["grad_bias"]["kernel"],
           "library_bf16_mask_ms": libs["bf16_mask"]["ms"],
           "library_bf16_mask_kernel": libs["bf16_mask"]["kernel"],
           "library_device_ms": libs["grad_bias"]["device_ms"],
           "library_bf16_mask_device_ms": libs["bf16_mask"]["device_ms"],
           "bound_ms": bound_ms, "bound_by": bound_by,
           "bound_share": None if device_ms is None else bound_ms / device_ms,
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


def _b9_products(C):
    """B9's window-GEMM launches: (name, K, N, epilogue, gather, scatter)."""
    from vit_torch_tpu_torch.ops import gemm as gm
    return (("qkv", C, 3 * C, gm.EPI_BIAS, True, False),
            ("proj", C, C, gm.EPI_BIAS_RES, False, True),
            ("fc1", C, 4 * C, gm.EPI_GELU, False, False),
            ("fc2", 4 * C, C, gm.EPI_BIAS16_RES, False, False))


def check_window_gemm(case, d, launch_ms, products=None, label=""):
    """B9's four window-GEMM launches at one block case (or ``products``,
    another chain's launches; ``label`` tags its line), each launched
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

    rows = []
    for name, K, N, epi, gather, scatter in products or _b9_products(C):
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
        rows.append({
            "launch": name, "T": T, "K": K, "N": N,
            "plan": gm.gemm_plan(T, K, N)._asdict(),
            "max_abs_err": err, "max_rel_err": rel, "device_ms": ms,
            "tflops": None if ms is None else flops / ms / 1e9,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": None if ms is None else bound_ms / ms,
            "plain_ms": plain_ms, "library_ms": _time_ms(library, iters=20),
            "library_device_ms": library_device_ms,
            "library_tflops": (None if library_device_ms is None
                               else flops / library_device_ms / 1e9),
            "library_backend": _library_backend(library),
            "index_select_linear_ms": (None if permuted is None
                                       else _time_ms(permuted, iters=20))})
        del a, res, out
    row = {"case": list(case), "products": rows}
    _say(f"kernel check window_gemm{label}", json.dumps(row))
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
    if "auction_kernel" in name:
        return "auction"
    if "GroupNorm" in name or "group_norm" in low or any(k in name for k in (
            "RowwiseMomentsCUDAKernel", "ComputeFusedParamsCUDAKernel",
            "ComputeInternalGradientsCUDAKernel",
            "ComputeBackwardFusedParamsCUDAKernel",
            "Compute1dBackwardFusedParamsCUDAKernel")):
        # PyTorch's GroupNorm (DETRSegm's mask head): its statistics and
        # fused-parameter kernels and the elementwise lambdas of its
        # forward and backward (the port's LayerNorm takes the vectorised
        # layer-norm kernels, not the row-moments one)
        return "group_norm"
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
                     buckets: str = BUCKETS, per_dispatch=None,
                     export_flags=()):
    """Export → BundleServer on cuda → concurrent HTTP requests; prints
    the serving numbers and returns the launch counts of the HTTP run.
    Each of ``kernels`` must launch once per layer (``per_dispatch`` times
    when given) per dispatch, or, where ``kernels`` maps names to counts,
    that many times per dispatch; no other kernel may launch at all.
    ``export_flags`` go to ``cli.export`` (``--w8a8``).  ``plain()`` is
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

    bundle = "-".join([f"{workdir}/bundle-{arch}",
                       *(f.strip("-") for f in export_flags)])
    t0 = time.perf_counter()
    cli_export.main(["--arch", arch, "--classifier", CLASSIFIER,
                     "--image_size", str(image_size), "--bs", buckets,
                     "--dataset", "stl10", "--out", bundle, *export_flags])
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
        per = (kernels if isinstance(kernels, dict)
               else {k: depth for k in kernels})
        want = _want(**{k: n * dispatches for k, n in per.items()})
        if launches != want or dispatches == 0:
            raise AssertionError(f"{arch} launches {launches} != {want} "
                                 f"({per} a dispatch x {dispatches} "
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
    from vit_torch_tpu_torch.detection import matcher
    from vit_torch_tpu_torch.ops import attn_block as ab
    from vit_torch_tpu_torch.ops import flash_attention as fa
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    from vit_torch_tpu_torch.ops import gemm as gm
    from vit_torch_tpu_torch.ops import quant
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
            "window_gemm": gm.gemm,
            "w8a8_quantize_rows": quant.quantize_rowwise,
            "w8a8_gemm": quant.int8_gemm,
            "auction": matcher.auction_assign}


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


def _zero_out_bias(args):
    """B12's inputs with a zero output bias, as ``Mlp._forward_tp`` passes
    them (fc2's bias is added once, after the all-reduce)."""
    import torch
    return (*args[:4], torch.zeros_like(args[4]))


def check_fused_mlp(shape, seed, zero_out_bias=False):
    """B12 (row 12) vs its plain version on one (T, C, hidden, out) shape
    (``zero_out_bias``: fc2's bias zero); times the kernel on CUDA events
    and its device time from the profiler, the plain version and the
    port's default MLP (cuBLAS + GELU + cuBLAS)."""
    import torch
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co, bias = shape
    args = _mlp_inputs(T, C, Hd, Co, seed, bias)
    if zero_out_bias:
        args = _zero_out_bias(args)
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
    row = {"shape": [T, C, Hd, Co], "biases": bias,
           "zero_out_bias": zero_out_bias, "max_abs_err": abs_err,
           "max_rel_err": rel, "ms": ms, "device_ms": device_ms,
           "plain_ms": plain_ms, "library_ms": library_ms,
           "bound_ms": bound_ms, "bound_by": bound_by, "plan": plan,
           "tflops": None if device_ms is None else flops / device_ms / 1e9,
           "library_tflops": flops / library_ms / 1e9,
           "bound_share": None if device_ms is None else bound_ms / device_ms}
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


def check_fused_mlp_grads(shape, seed, zero_out_bias=False):
    """All five gradients of B12 through its autograd Function (one kernel
    launch forward, the backward a recompute through cuBLAS) vs autograd
    through the plain version (``zero_out_bias``: fc2's bias zero, no
    gradient asked of it); times a forward and backward of each and of the
    port's default MLP."""
    import torch
    from vit_torch_tpu_torch.ops import fused_mlp as fm
    T, C, Hd, Co, bias = shape
    args = _mlp_inputs(T, C, Hd, Co, seed, bias)
    if zero_out_bias:
        args = _zero_out_bias(args)
    leaves = [t.requires_grad_(True) for t in args[:4]]
    if not zero_out_bias:
        leaves.append(args[4].requires_grad_(True))
    args = (*leaves, *args[len(leaves):])
    gen = torch.Generator(device="cuda").manual_seed(9500 + seed)
    dout = torch.randn((T, Co), generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    before = fm.fused_mlp.launches
    got = torch.autograd.grad(fm.fused_mlp(*args), leaves, dout)
    torch.cuda.synchronize()
    if fm.fused_mlp.launches != before + 1:
        raise AssertionError("fused_mlp grad: not one forward launch")
    want = torch.autograd.grad(fm.fused_mlp_reference(*args), leaves, dout)
    rel = [_rel_err(g, w) for g, w in zip(got, want)]
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    if not (finite and max(rel) <= MLP_GRAD_RTOL):
        raise AssertionError(f"fused_mlp grads {shape}: error relative to "
                             f"max|plain| {rel} (limit {MLP_GRAD_RTOL})")
    ms = _time_ms(lambda: torch.autograd.grad(fm.fused_mlp(*args), leaves,
                                              dout), iters=10)
    library_ms = _time_ms(lambda: torch.autograd.grad(
        _library_mlp(*args), leaves, dout), iters=10)
    row = {"shape": [T, C, Hd, Co], "zero_out_bias": zero_out_bias,
           "grad_rel_err": rel, "fwd_bwd_ms": ms,
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


def _cli_trainer(argv, fp: str, mode: str, want, augment_off=False,
                 read_stats=True):
    """One run of ``cli.main`` on the card; returns its trainer, the
    kernels' launch counts (checked against ``want``) and its seconds.
    ``augment_off`` gives the CLI's train augmentation no crop and no
    flip (the resume phase's order-free configuration); without
    ``read_stats`` (a rank other than 0, which writes no stats file) only
    the launches are checked."""
    import contextlib
    import functools
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.data.augment import make_train_augment
    seen = []

    class Recording(cli_main.Trainer):
        def __init__(self, zoo_model, **kw):
            super().__init__(zoo_model, **kw)
            seen.append(self)

    with contextlib.ExitStack() as stack:
        stack.enter_context(mock.patch.object(cli_main, "Trainer",
                                              Recording))
        if augment_off:
            stack.enter_context(mock.patch.object(
                cli_main, "make_train_augment", functools.partial(
                    make_train_augment, crop_pad=0, hflip=False)))
        _reset_counts()
        t0 = time.perf_counter()
        cli_main.main(argv + ["--stats_fp", fp])
        seconds = time.perf_counter() - t0
        counts = _read_counts()
    if not read_stats:
        if counts != want:
            raise AssertionError(f"{mode}: kernel launches {counts} != "
                                 f"{want}")
        return seen[0], counts, seconds
    with open(fp) as f:
        stats = json.load(f)
    _say(json.dumps({"cli": {"mode": mode, "seconds": seconds,
                             "launches": counts, "want": want,
                             "results": stats["results"]}}))
    if counts != want:
        raise AssertionError(f"{mode}: kernel launches {counts} != {want}")
    for split in ("train", "val"):
        if not all(np.isfinite(r["loss"]) for r in stats[split]):
            raise AssertionError(f"{mode}: bad {split} rows {stats[split]}")
    return seen[0], counts, seconds


def _same_state(got, want, where: str) -> None:
    """Nested dicts and lists of tensors and numbers, bitwise."""
    import torch
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{where}: keys {sorted(got)} != "
                                 f"{sorted(want)}")
        for k in want:
            _same_state(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{where}: length {len(got)} != {len(want)}")
        for i, (g, w) in enumerate(zip(got, want)):
            _same_state(g, w, f"{where}[{i}]")
    elif isinstance(want, torch.Tensor):
        if not (got.dtype == want.dtype and torch.equal(got.cpu(),
                                                        want.cpu())):
            raise AssertionError(f"{where}: restored tensor differs")
    elif got != want:
        raise AssertionError(f"{where}: {got!r} != {want!r}")


def resume_through_cli(workdir: str):
    """dino_vitb8 fine-tuned for two epochs through ``cli.main`` with
    ``--ckpt_dir --save_every 1 --export_bundle``; the layout checked, the
    latest checkpoint held bitwise against the trainer's state in memory
    (parameters, AdamW moments, step, generator), save and restore timed;
    then epoch 1 again from the epoch-0 checkpoint through ``--resume``,
    its flash launches counted and its parameters held against the
    unbroken run's (RESUME_ATOL, RESUME_UPDATE_RTOL)."""
    import shutil
    import torch
    from vit_torch_tpu_torch.checkpoint import ckpt_io
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    depth = VIT_CONFIGS[ARCH].depth
    full_dir, res_dir = f"{workdir}/ckpt-unbroken", f"{workdir}/ckpt-resumed"
    bundle = f"{workdir}/bundle-trained"
    full, full_counts, full_s = _cli_trainer(
        RESUME_ARGS + ["--epoch", "2", "--ckpt_dir", full_dir,
                       "--save_every", "1", "--export_bundle", bundle,
                       "--export_bs", BUCKETS],
        f"{workdir}/resume_unbroken.json", "resume_unbroken",
        _want(flash_attention_fwd=4 * depth, flash_attention_bwd=2 * depth),
        augment_off=True)
    steps = ckpt_io._steps(full_dir)
    best = ckpt_io._steps(f"{full_dir}/{ckpt_io.BEST_SUBDIR}")
    metrics = ckpt_io.saved_metrics(full_dir)
    if steps != [0, 1] or len(best) != 1 or sorted(metrics) != [0, 1]:
        raise AssertionError(f"checkpoint layout: steps {steps}, best "
                             f"{best}, metrics {metrics}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = ckpt_io.restore_checkpoint(full_dir, map_location="cuda")
    torch.cuda.synchronize()
    restore_ms = 1e3 * (time.perf_counter() - t0)
    in_memory = full.checkpoint_state(1)
    _same_state(restored, in_memory, "checkpoint")
    moments = sum(len(st) for st in restored["optimizer"]["state"].values())
    t0 = time.perf_counter()
    ckpt_io.save_checkpoint(f"{workdir}/ckpt-timed", in_memory, 1)
    save_ms = 1e3 * (time.perf_counter() - t0)
    ckpt_bytes = os.path.getsize(f"{full_dir}/1/state.pt")
    del restored

    # epoch 1 again, resumed from the unbroken run's epoch-0 checkpoint
    shutil.copytree(f"{full_dir}/0", f"{res_dir}/0")
    with open(f"{res_dir}/metrics.json", "w") as f:
        json.dump({"0": metrics[0]}, f)
    resumed, res_counts, res_s = _cli_trainer(
        RESUME_ARGS + ["--epoch", "2", "--resume", res_dir, "--ckpt_dir",
                       res_dir, "--save_every", "1"],
        f"{workdir}/resume_resumed.json", "resume",
        _want(flash_attention_fwd=2 * depth, flash_attention_bwd=depth),
        augment_off=True)
    if resumed.start_epoch != 1 or ckpt_io._steps(res_dir) != [0, 1]:
        raise AssertionError(f"resumed at {resumed.start_epoch}, steps "
                             f"{ckpt_io._steps(res_dir)}")
    start = ckpt_io.restore_checkpoint(full_dir, 0,
                                       map_location="cuda")["model"]
    a, b = full.model.state_dict(), resumed.model.state_dict()
    max_abs, diff_sq, update_sq = 0.0, 0.0, 0.0
    for k, v in a.items():
        if not v.is_floating_point():
            continue
        d = (b[k].double() - v.double())
        max_abs = max(max_abs, float(d.abs().max()))
        diff_sq += float((d * d).sum())
        u = v.double() - start[k].double()
        update_sq += float((u * u).sum())
    update_rel = (diff_sq / update_sq) ** 0.5
    row = {"arch": ARCH, "bs": TRAIN_BS, "unbroken_seconds": full_s,
           "resumed_seconds": res_s, "steps": steps, "best": best,
           "metrics": metrics, "checkpoint_bytes": ckpt_bytes,
           "optimizer_state_tensors": moments, "save_ms": save_ms,
           "restore_ms": restore_ms, "restored_bitwise": True,
           "resumed_max_abs_diff": max_abs,
           "resumed_update_rel_diff": update_rel,
           "limits": [RESUME_ATOL, RESUME_UPDATE_RTOL],
           "launches_unbroken": full_counts,
           "launches_resumed_epoch": res_counts}
    _say(json.dumps({"resume": row}))
    if not (max_abs <= RESUME_ATOL and update_rel <= RESUME_UPDATE_RTOL):
        raise AssertionError(f"resumed parameters differ from the unbroken "
                             f"run's: max {max_abs}, update {update_rel}")
    del full, resumed, a, b, start
    return {"row": row, "bundle": bundle, "resumed": res_counts,
            "unbroken": full_counts}


def serve_trained_bundle(bundle: str):
    """The resume phase's ``--export_bundle``, loaded by ``BundleServer``
    on the card; one 32-image request, its logits held against the
    trained weights' fp32 CPU forward (LOGITS: 5e-2 of max |logit|, as
    the other served models)."""
    from vit_torch_tpu_torch.serving.server import BundleServer
    server = BundleServer(bundle, port=0, max_wait_ms=10)
    try:
        depth = _depth(server.model.model.backbone)
        server.start()
        batch = np.random.default_rng(1).integers(
            0, 256, (TRAIN_BS, IMAGE_SIZE, IMAGE_SIZE, 3), dtype=np.uint8)
        server.model.predict(batch)
        _reset_counts()
        t0 = time.perf_counter()
        status, body = _post(server.address,
                             {"images": [_png_b64(img) for img in batch]})
        seconds = time.perf_counter() - t0
        launches = _read_counts()
        if status != 200:
            raise AssertionError(f"predict answered {status}: {body}")
        _, stats = _get(server.address, "/stats")
        dispatches = sum(stats["dispatches"].values())
        got = np.asarray([p["logits"] for p in body["predictions"]])
        want = _cpu_fp32_logits(bundle, batch)
        err = float(np.abs(got - want).max())
        max_logit = float(np.abs(want).max())
        row = {"bundle_manifest": server.model.manifest, "seconds": seconds,
               "dispatches": stats["dispatches"], "launches": launches,
               "logits_max_abs_err": err, "max_abs_logit": max_logit,
               "argmax_agree": int((got.argmax(1) == want.argmax(1)).sum())}
        _say(json.dumps({"export_bundle": row}))
        if launches != _want(flash_attention_fwd=depth * dispatches):
            raise AssertionError(f"served launches {launches}")
        if got.shape != (TRAIN_BS, 10) or not err <= CONV_LOGITS_RTOL * \
                max_logit:
            raise AssertionError(f"served logits off by {err} (max |logit| "
                                 f"{max_logit})")
        return launches
    finally:
        server.shutdown()


def check_autoaugment_ops(seed: int = 0):
    """Every AutoAugment op at bs32 @224 on the card against the same op
    on the CPU with the same draws (magnitudes and signs from a seed):
    the share of pixels more than one level apart, and the op's time."""
    import torch
    from vit_torch_tpu_torch.data import autoaugment as aa
    rng = np.random.default_rng(seed)
    imgs = torch.from_numpy(rng.integers(
        0, 256, (TRAIN_BS, IMAGE_SIZE, IMAGE_SIZE, 3)).astype(np.float32))
    imgs_d = imgs.cuda()
    rows = {}
    for k, name in enumerate(aa.OP_NAMES):
        levels = aa._RANGES[name]
        mags = torch.tensor([float(levels[i]) for i in
                             rng.integers(0, 10, TRAIN_BS)])
        signs = torch.from_numpy(rng.choice([-1.0, 1.0], TRAIN_BS).astype(
            np.float32))
        mags_d, signs_d = mags.cuda(), signs.cuda()
        cpu = aa.OP_FNS[k](imgs, mags, signs)
        card = aa.OP_FNS[k](imgs_d, mags_d, signs_d)
        diff = (card.cpu() - cpu).abs()
        share = float((diff > 1).float().mean())
        ms = _time_ms(lambda: aa.OP_FNS[k](imgs_d, mags_d, signs_d),
                      iters=5)
        limit = AA_WARP_SHARE if name in AA_WARPS else 0.0
        rows[name] = {"share_over_one_level": share,
                      "max_abs_diff": float(diff.max()), "ms": ms,
                      "limit": limit}
        if share > limit:
            raise AssertionError(f"autoaugment {name}: {share} of the "
                                 f"pixels differ by more than one level")
    _say(json.dumps({"autoaugment_ops": rows}))
    return rows


def steady_state_aug_auto(iters: int = 8):
    """The dino_vitb8 bs32 fine-tune step with the plain train
    augmentation and with ``auto_policy="imagenet"``, off, on, on, off,
    and the two augmentations' device time from one profiler pass."""
    import torch
    from vit_torch_tpu_torch.data.augment import make_train_augment
    from vit_torch_tpu_torch.data.datasets import NORM_VALUES
    from vit_torch_tpu_torch.train.steps import make_train_step
    zm, trainer, batch = _train_setup(TRAIN_BS)
    zm.model.train()
    augments = {side: make_train_augment(
        **NORM_VALUES["synthetic"], dtype=torch.bfloat16,
        auto_policy=policy) for side, policy in (("off", None),
                                                 ("on", "imagenet"))}
    steps = {side: make_train_step(zm.model, trainer.optimizer, fn,
                                   generator=trainer.generator)
             for side, fn in augments.items()}
    out = {"off": [], "on": []}
    for side in ("off", "on", "on", "off"):
        trainer.train_step = steps[side]
        t = _time_train_steps(trainer, batch, iters)
        out[side].append({"step_ms": t["step_ms"],
                          "host_step_ms": t["host_step_ms"],
                          "device_busy_ms": t["profile"]["device_busy_ms"]})
    for side, fn in augments.items():
        prof = _profile_calls(lambda: fn(trainer.generator, batch[0]), 2)
        out[f"augment_{side}"] = {"device_ms": prof["device_busy_ms"],
                                  "host_ms": prof["window_ms"],
                                  "groups_ms": prof["groups_ms"]}
    _say(json.dumps({"aug_auto_steady_state": out}))
    return out


def _tire_folder(root: str, seed: int = 0) -> str:
    """Two classes of TIRE_PER_CLASS PNGs in TIRE_SIZES, made from a seed:
    a class-dependent stripe pattern under noise."""
    from PIL import Image
    rng = np.random.default_rng(seed)
    for c, name in enumerate(("tread_a", "tread_b")):
        os.makedirs(f"{root}/{name}")
        for i in range(TIRE_PER_CLASS):
            h, w = TIRE_SIZES[i % len(TIRE_SIZES)]
            yy, xx = np.mgrid[0:h, 0:w] / 16.0
            base = 128 + 60 * np.sin(yy * (1 + c) + xx * (2 - c))
            img = base[..., None] + rng.normal(0, 30, (h, w, 3))
            Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(
                f"{root}/{name}/{i:02d}.png")
    return root


def tire_through_cli(workdir: str, folder: str, aug_auto: bool):
    """dino_vits16 @224 on the tire data, setting 0 (7 channels), one
    epoch through ``cli.main``: 1 train step, 1 eval step."""
    extra = ["--aug_auto", "imagenet"] if aug_auto else []
    mode = "tire" + ("_aug_auto" if aug_auto else "")
    _, counts, seconds = _cli_trainer(
        TIRE_ARGS + ["--data_path", folder] + extra, f"{workdir}/{mode}.json",
        mode, _want(flash_attention_fwd=2 * VITS_DEPTH,
                    flash_attention_bwd=VITS_DEPTH))
    return dict(counts, seconds=seconds)


def check_lbp_device(folder: str):
    """``lbp_device`` on the card against the host ``lbp.py`` on the same
    images (the tire phase's letterboxed test split at 224, setting 0):
    the count of codes that differ (the JAX package claims 0 for its own),
    and the device LBP's time at bs32."""
    import torch
    from vit_torch_tpu_torch.data.datasets import _imagefolder_arrays
    from vit_torch_tpu_torch.data.lbp import get_lbp_merge
    from vit_torch_tpu_torch.data.lbp_device import lbp_merge_device
    from vit_torch_tpu_torch.data.tire import (TIRE_LBP_POINT_MULT,
                                               TIRE_LBP_RADIUS,
                                               TIRE_SETTINGS)
    methods = TIRE_SETTINGS[0]["methods"]
    splits, _ = _imagefolder_arrays(folder, VITS_SIZE, letterbox=True)
    imgs = splits["test"][0]
    kw = dict(radius=TIRE_LBP_RADIUS, point_mult=TIRE_LBP_POINT_MULT,
              methods=methods)
    card = lbp_merge_device(torch.from_numpy(imgs).cuda(), **kw).cpu()
    host = np.stack([get_lbp_merge(img, **kw) for img in imgs])
    differ = int((card.numpy() != host).sum())
    batch = torch.from_numpy(np.concatenate(
        [splits["train"][0][:TRAIN_BS - len(imgs)], imgs])).cuda()
    ms = _time_ms(lambda: lbp_merge_device(batch, **kw), iters=5)
    row = {"images": len(imgs), "codes": int(host.size),
           "codes_differing": differ, "bs32_ms": ms,
           "shape": list(batch.shape), "methods": list(methods)}
    _say(json.dumps({"lbp_device": row}))
    if differ:
        raise AssertionError(f"device LBP differs from the host in {differ} "
                             f"codes")
    return row


def lifecycle_and_data_extras():
    """The training life cycle (resume, ``--export_bundle``) and the data
    extras (AutoAugment, the tire data, device LBP): no kernel of their
    own; their ViT steps run rows 1-2.  Prints their summary line and
    returns the flash launch counts of each path."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    with tempfile.TemporaryDirectory() as workdir:
        resume = resume_through_cli(workdir)
        bundle_launches = serve_trained_bundle(resume["bundle"])
    aa_ops = check_autoaugment_ops()
    depth, steps = VIT_CONFIGS[ARCH].depth, SYNTHETIC_N // TRAIN_BS
    with tempfile.TemporaryDirectory() as workdir:
        aug_auto = _run_cli(
            cli_main.main, TRAIN_ARGS + ["--aug_auto", "imagenet"],
            f"{workdir}/aug_auto.json", "aug_auto",
            _want(flash_attention_fwd=depth * 2 * steps,
                  flash_attention_bwd=depth * steps))
    aa_steps = steady_state_aug_auto()
    with tempfile.TemporaryDirectory() as workdir:
        folder = _tire_folder(f"{workdir}/tire")
        tire_paths = {mode: tire_through_cli(workdir, folder, on)
                      for mode, on in (("tire", False),
                                       ("tire_aug_auto", True))}
        lbp_row = check_lbp_device(folder)
    paths = {"resume_unbroken": resume["unbroken"],
             "resume_resumed_epoch": resume["resumed"],
             "export_bundle_serve": bundle_launches, "aug_auto": aug_auto,
             **tire_paths}
    _say(json.dumps({"lifecycle_and_data_extras": {
        "resume": resume["row"], "launches_by_path": paths,
        "autoaugment_ops": aa_ops, "aug_auto_steps": aa_steps,
        "lbp_device": lbp_row}}))
    return paths


def _w8a8_bounds(T, K, N):
    """(least ms, what bounds it) of Q1 over a (T, K) bf16 input (read
    once; codes and fp32 scales written once) and of Q2 over (T, K) and
    (N, K) codes, the scales and an fp32 bias, bf16 out (2 T K N int8
    operations at the dense int8 peak)."""
    q1 = 1e3 * (T * K * 2 + T * K + T * 4) / H100_BYTES_PER_S
    t_ops = 2 * T * K * N / H100_INT8_OPS
    t_bytes = (T * K + N * K + T * N * 2 + T * 4 + N * 8) / H100_BYTES_PER_S
    return ((q1, "bytes"),
            (1e3 * max(t_ops, t_bytes),
             "operations" if t_ops >= t_bytes else "bytes"))


def _max_ulps(got, want) -> int:
    """Largest elementwise distance, in units in the last place of got's
    dtype (fp32 or bf16, compared as ordered integers)."""
    import torch
    bits = {torch.float32: torch.int32, torch.bfloat16: torch.int16}
    mag = 2 ** (8 * got.element_size() - 1) - 1
    a, b = (t.contiguous().view(bits[t.dtype]).long() for t in (got, want))
    a = torch.where(a < 0, -(a & mag), a)
    b = torch.where(b < 0, -(b & mag), b)
    return int((a - b).abs().max().item())


def check_w8a8_kernels(shape, seed):
    """Q1 and Q2 (``csrc/w8a8.cu``) against their plain versions at one
    (T, K, N) product: Q1 on bf16 activations and the fp32 weight (codes
    and scales bit for bit), Q2 in bf16 out with a bias (the model's) and
    fp32 out (within W8A8_ULPS); each timed on CUDA events and by its
    device time, beside its plain version, its bound (with Q1's share of
    it and its plans) and the library yardsticks: none for Q1;
    ``torch._int_mm`` plus the same rescale for Q2 (timed only), and the
    bf16 product ``F.linear`` the int8 pair replaces."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import quant
    T, K, N = shape
    gen = torch.Generator().manual_seed(seed)
    x = (torch.randn((T, K), generator=gen) * torch.exp(
        torch.randn((T, 1), generator=gen))).cuda().bfloat16()
    w = (0.03 * torch.randn((N, K), generator=gen)).cuda()
    b = (0.1 * torch.randn((N,), generator=gen)).cuda()
    before = (quant.quantize_rowwise.launches, quant.int8_gemm.launches)
    x_q, x_s = quant.quantize_rowwise(x)
    w_q, w_s = quant.quantize_weight(w)
    x_s = x_s.view(-1)
    y = quant.int8_gemm(x_q, x_s, w_q, w_s, b, torch.bfloat16)
    y32 = quant.int8_gemm(x_q, x_s, w_q, w_s, b, torch.float32)
    torch.cuda.synchronize()
    if (quant.quantize_rowwise.launches - before[0],
            quant.int8_gemm.launches - before[1]) != (2, 2):
        raise AssertionError(f"w8a8 {shape}: the kernels did not launch")
    q1_errs = []
    for (q, sc), src in (((x_q, x_s), x), ((w_q, w_s), w)):
        ref_q, ref_s = quant.quantize_rowwise_reference(src)
        q1_errs.append(max(
            (q.int() - ref_q.int()).abs().max().item(),
            (sc - ref_s.view(-1)).abs().max().item()))
    ulps = [_max_ulps(got, quant.int8_gemm_reference(
        x_q, x_s, w_q, w_s, b, got.dtype)) for got in (y, y32)]
    ref = quant.int8_gemm_reference(x_q, x_s, w_q, w_s, b, torch.float32)
    q2_err = (y32 - ref).abs().max().item()
    if max(q1_errs) != 0 or max(ulps) > W8A8_ULPS or not (
            torch.isfinite(y).all() and torch.isfinite(y32).all()):
        raise AssertionError(f"w8a8 {shape}: Q1 max err {q1_errs} (must be "
                             f"0), Q2 max ulps {ulps} > {W8A8_ULPS}")
    del y, y32, ref

    def q1():
        return quant.quantize_rowwise(x)

    def q2():
        return quant.int8_gemm(x_q, x_s, w_q, w_s, b, torch.bfloat16)

    def int_mm():
        acc = torch._int_mm(x_q, w_q.t())
        return (acc.float() * x_s[:, None] * w_s + b).bfloat16()

    wb16, bb16 = w.bfloat16(), b.bfloat16()
    try:
        int_mm()
        lib_ms, lib_error = _time_ms(int_mm, iters=20), None
    except RuntimeError as e:   # the yardstick only; the port never calls it
        lib_ms, lib_error = None, str(e)[:120]
    (q1_bound, q1_by), (q2_bound, q2_by) = _w8a8_bounds(T, K, N)
    # per launch the profiler recorded: a pass now and then drops some
    # (see _cuda_events), and a mean over the calls would then read low;
    # None ("not measured") where it recorded none
    q1_dev, q2_dev = (t / n if n else None for t, n in _device_times(
        lambda: (q1(), q2()), ("quantize_rows_kernel", "w8a8_gemm_kernel")))
    row = {"shape": [T, K, N],
           "q1": {"max_abs_err": max(q1_errs),
                  "ms": _time_ms(q1, iters=20), "device_ms": q1_dev,
                  "plain_ms": _time_ms(
                      lambda: quant.quantize_rowwise_reference(x), iters=5),
                  "bound_ms": q1_bound, "bound_by": q1_by,
                  "library_ms": None},
           "q2": {"max_abs_err": q2_err, "max_ulps_bf16_fp32": ulps,
                  "ms": _time_ms(q2, iters=20), "device_ms": q2_dev,
                  "plain_ms": _time_ms(lambda: quant.int8_gemm_reference(
                      x_q, x_s, w_q, w_s, b, torch.bfloat16), iters=3),
                  "bound_ms": q2_bound, "bound_by": q2_by,
                  "library_ms": lib_ms, "library_error": lib_error,
                  "bf16_linear_ms": _time_ms(
                      lambda: F.linear(x, wb16, bb16), iters=20)}}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    # Q1's share of its bound, and its plans: the bf16 activations' (the
    # timed launch) and the fp32 weight's
    row["q1"]["bound_share"] = q1_bound / (q1_dev or row["q1"]["ms"])
    row["q1"]["plan"] = quant.quant_plan(T, K, 2, sms)._asdict()
    row["q1"]["weight_plan"] = quant.quant_plan(N, K, 4, sms)._asdict()
    q2_ms = q2_dev or row["q2"]["ms"]   # events where not measured
    row["q2"]["tops"] = 2 * T * K * N / q2_ms / 1e9
    row["q2"]["bound_share"] = q2_bound / q2_ms
    # the bf16 launch's plan; the consumer warpgroups share each tile
    # (cooperative), its epilogue leaving by TMA stores
    row["q2"]["plan"] = {**quant.int8_plan(T, K, N, sms)._asdict(),
                         "schedule": "cooperative, TMA-store epilogue"}
    _say("kernel check w8a8", json.dumps(row))
    return row


def _plain_w8a8():
    """Q1, Q2 and the flash attention on their plain versions, patched in
    for the served-logits comparison."""
    import contextlib
    from vit_torch_tpu_torch.ops import quant
    stack = contextlib.ExitStack()
    stack.enter_context(_plain_attention())
    stack.enter_context(mock.patch.object(
        quant, "quantize_rowwise", quant.quantize_rowwise_reference))
    stack.enter_context(mock.patch.object(
        quant, "int8_gemm", quant.int8_gemm_reference))
    return stack


def _cosine(a, b) -> float:
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def serve_w8a8(workdir: str):
    """dino_vitb8 @224 exported through ``cli.export --w8a8`` (int8 weights
    prequantised) and served over HTTP: per dispatch, 4 Q1 and 4 Q2
    launches and one flash launch a block, nothing else; the logits held
    against the plain versions.  Then the fp bundle of the same seeded
    weights: bundle bytes, the two bundles' logits on one batch (cosine,
    top-1 agreement), their predict times and their forwards' times in
    turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from vit_torch_tpu_torch.cli import export as cli_export
    from vit_torch_tpu_torch.data.datasets import resize_images
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    from vit_torch_tpu_torch.serving import load_bundle
    depth = VIT_CONFIGS[ARCH].depth
    per = {"flash_attention_fwd": depth, "w8a8_quantize_rows": 4 * depth,
           "w8a8_gemm": 4 * depth}
    launches = serve_end_to_end(
        workdir, ARCH, IMAGE_SIZE, per, _plain_w8a8,
        vit_flops(VIT_CONFIGS[ARCH], IMAGE_SIZE), W8A8_LOGITS_RTOL,
        relative=True, export_flags=("--w8a8",))
    bundles = {"w8a8": f"{workdir}/bundle-{ARCH}-w8a8",
               "fp": f"{workdir}/bundle-{ARCH}-fp"}
    cli_export.main(["--arch", ARCH, "--classifier", CLASSIFIER,
                     "--image_size", str(IMAGE_SIZE), "--bs", BUCKETS,
                     "--dataset", "stl10", "--out", bundles["fp"]])
    models = {k: load_bundle(v) for k, v in bundles.items()}
    if not (models["w8a8"].manifest["w8a8"]
            and models["w8a8"].manifest["w8a8_prequant"]
            and not models["fp"].manifest["w8a8"]):
        raise AssertionError("the W8A8 bundle's manifest does not say so")
    rng = np.random.default_rng(1)
    big = int(BUCKETS.split(",")[-1])
    batch = resize_images(rng.integers(0, 256, (big, 256, 256, 3),
                                       dtype=np.uint8), IMAGE_SIZE)
    logits = {k: m.predict(batch) for k, m in models.items()}
    cos = _cosine(logits["w8a8"], logits["fp"])
    top1 = int((logits["w8a8"].argmax(1) == logits["fp"].argmax(1)).sum())
    if not (np.isfinite(logits["w8a8"]).all() and cos > W8A8_MIN_COSINE):
        raise AssertionError(f"W8A8 logits against the fp bundle's: cosine "
                             f"{cos} <= {W8A8_MIN_COSINE}")
    predict_ms = {"fp": [], "w8a8": []}
    for k in ("fp", "w8a8", "w8a8", "fp"):
        models[k].predict(batch)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            models[k].predict(batch)
        predict_ms[k].append(1e3 * (time.perf_counter() - t0) / 10)
    # the model's forward alone, in the same turns: CUDA events, the host's
    # time to enqueue the timed forwards (near the events time, the
    # forward is bound by the host), and one profiler pass's device busy
    # time with Q1's and Q2's share
    fwd = {k: {"ms": [], "enqueue_ms": [], "busy_ms": [], "q1_ms": [],
               "q2_ms": []} for k in models}
    for k in ("fp", "w8a8", "w8a8", "fp"):
        m = models[k]
        x = torch.from_numpy(batch).to(m.device)
        with torch.inference_mode():
            def forward():
                return m.model((x.to(m.mean.dtype) / 255.0 - m.mean) / m.std)
            forward()
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter()
            start.record()
            for _ in range(10):
                forward()
            fwd[k]["enqueue_ms"].append(1e3 * (time.perf_counter() - t0) / 10)
            end.record()
            torch.cuda.synchronize()
            fwd[k]["ms"].append(start.elapsed_time(end) / 10)
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    forward()
                torch.cuda.synchronize()
        busy = q1 = q2 = 0.0
        for ev in prof.key_averages():
            if ev.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = ev.self_device_time_total / 1e3 / 3
            busy += ms
            q1 += ms if "quantize_rows_kernel" in ev.key else 0.0
            q2 += ms if "w8a8_gemm_kernel" in ev.key else 0.0
        fwd[k]["busy_ms"].append(busy)
        fwd[k]["q1_ms"].append(q1)
        fwd[k]["q2_ms"].append(q2)
    sizes = {k: os.path.getsize(f"{v}/weights.pt")
             for k, v in bundles.items()}
    row = {"arch": ARCH, "image_size": IMAGE_SIZE, "bucket": big,
           "launches_http": launches,
           "launches_per_dispatch": {k: per[k] for k in
                                     ("w8a8_quantize_rows", "w8a8_gemm")},
           "bundle_bytes": sizes,
           "bundle_bytes_ratio": sizes["w8a8"] / sizes["fp"],
           "cosine_vs_fp_bundle": cos, "top1_agree_vs_fp_bundle": top1,
           "top1_of": big, "predict_ms_fp_w8a8_w8a8_fp": [
               predict_ms["fp"][0], predict_ms["w8a8"][0],
               predict_ms["w8a8"][1], predict_ms["fp"][1]],
           "predict_img_per_s": {k: big * 1e3 / min(v)
                                 for k, v in predict_ms.items()},
           # each model's two turns of fp, w8a8, w8a8, fp
           "forward_ms_cuda_events": {k: v["ms"] for k, v in fwd.items()},
           "forward_enqueue_ms": {k: v["enqueue_ms"] for k, v in fwd.items()},
           "forward_busy_ms": {k: v["busy_ms"] for k, v in fwd.items()},
           "forward_q1_q2_ms": {k: [v["q1_ms"], v["q2_ms"]]
                                for k, v in fwd.items()}}
    _say(json.dumps({"w8a8_serve": row}))
    del models
    return row


def w8a8_every_family():
    """One full-width eval forward at bs8 of deit_base_distilled, cait_s24,
    xcit_small_24_p16 and swin_base_384 (seeded weights, bf16), with
    ``VITX_W8A8`` off and on: under it every QLinear runs once a forward
    (one Q2 launch, two Q1: activations and weight), Swin's blocks leave
    B9 for B8; the logits' cosine against the fp forward must exceed
    W8A8_MIN_COSINE.  Both forwards are timed on CUDA events."""
    import torch
    from vit_torch_tpu_torch.models.layers import QLinear
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    rows = []
    for arch, size in W8A8_FAMILIES:
        zm = VisionModelZoo.get_model(arch, classifier=[10],
                                      image_size=size)
        model = zm.model.eval()
        with torch.no_grad():   # LayerScale gates up from their init, as
            for name, p in model.named_parameters():   # the serve phases
                if ".gamma" in name:
                    p.fill_(CAIT_GAMMA if arch == CAIT_ARCH else CONV_GAMMA)
        sites = sum(isinstance(m, QLinear) for m in model.modules())
        x = torch.from_numpy(np.random.default_rng(0).standard_normal(
            (W8A8_FAMILY_BS, size, size, 3)).astype(np.float32)).cuda()
        x = x.bfloat16()
        out, counts, ms = {}, {}, {}
        for on in (False, True):
            with mock.patch.dict(os.environ, {"VITX_W8A8": "1" if on
                                              else ""}), \
                    torch.inference_mode():
                _reset_counts()
                out[on] = model(x).float().cpu().numpy()
                torch.cuda.synchronize()
                counts[on] = _read_counts()
                ms[on] = _time_ms(lambda: model(x), iters=5)
        cos = _cosine(out[True], out[False])
        q = counts[True]
        want_b9 = (0, SWIN_DEPTH) if arch == SWIN_ARCH else (0, 0)
        if (q["w8a8_gemm"] != sites or q["w8a8_quantize_rows"] != 2 * sites
                or counts[False]["w8a8_gemm"] != 0
                or (q["window_block_full_spatial"],
                    counts[False]["window_block_full_spatial"]) != want_b9
                or not np.isfinite(out[True]).all()
                or cos <= W8A8_MIN_COSINE):
            raise AssertionError(f"W8A8 {arch}: launches {q} ({sites} "
                                 f"QLinear), off {counts[False]}, cosine "
                                 f"{cos}")
        rows.append({"arch": arch, "image_size": size,
                     "bs": W8A8_FAMILY_BS, "qlinear": sites,
                     "launches_w8a8": {k: v for k, v in q.items() if v},
                     "launches_fp": {k: v for k, v in counts[False].items()
                                     if v},
                     "cosine": cos,
                     "top1_agree": int((out[True].argmax(1)
                                        == out[False].argmax(1)).sum()),
                     "forward_ms_fp_w8a8": [ms[False], ms[True]]})
        del model, zm
        torch.cuda.empty_cache()
    _say(json.dumps({"w8a8_families": rows}))
    return rows


def _cross_bounds_ms(B, H, Nq, Nk, D):
    """(forward, backward) bounds of attention of Nq queries over Nk keys:
    the forward's QK^T and PV against q, o (Nq rows) and k, v (Nk rows)
    read or written once; the backward's five products against q, o, dO,
    dq (Nq rows), k, v, dk, dv (Nk rows) and the fp32 LSE."""
    rows = B * H * D * 2
    return (_bound(4 * B * H * Nq * Nk * D, 2 * (Nq + Nk) * rows),
            _bound(10 * B * H * Nq * Nk * D,
                   4 * (Nq + Nk) * rows + B * H * Nq * 4))


def check_flash_cross(shape, seed):
    """The flash pair with a key length of its own, (B, H, Nq, Nk, D) at
    DETR's shapes: forward, LSE and backward through the model's (B, N, H,
    D) entry with grad, against the plain versions (KERNEL_ATOL, LSE_ATOL,
    BWD_RTOL); then the forward and the backward timed on CUDA events, the
    device time of each launch from the profiler, the plain versions, and
    SDPA forward and backward (events and device time, the backend it
    took).  At these shapes the work is a few microseconds of bound, so
    the launches set the time."""
    import torch
    import torch.nn.functional as F
    from vit_torch_tpu_torch.ops import flash_attention as fa
    B, H, Nq, Nk, D = shape
    gen = torch.Generator(device="cuda").manual_seed(2000 + seed)
    q, do = (torch.randn((B, Nq, H, D), generator=gen, device="cuda",
                         dtype=torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((B, Nk, H, D), generator=gen, device="cuda",
                        dtype=torch.bfloat16) for _ in range(2))
    scale = D ** -0.5
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention(*leaves, scale=scale)
    grads = torch.autograd.grad(out, leaves, do)
    torch.cuda.synchronize()
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    ref, lse_ref = fa.flash_attention_bhnd_reference(qt, kt, vt, scale=scale,
                                                     return_lse=True)
    o, lse = fa.flash_attention_fwd(qt, kt, vt, scale=scale,
                                    return_lse=True)
    err = (out.transpose(1, 2).float() - ref.float()).abs().max().item()
    lse_err = (lse - lse_ref).abs().max().item()
    errs, abs_err = [], 0.0
    for got, want in zip(grads, fa.flash_attention_bwd_reference(
            qt, kt, vt, dot, scale=scale)):
        want = want.float()
        diff = (got.transpose(1, 2).float() - want).abs().max().item()
        abs_err = max(abs_err, diff)
        errs.append(diff / max(want.abs().max().item(), BWD_FLOOR))
    if not (torch.isfinite(out).all() and err <= KERNEL_ATOL
            and lse_err <= LSE_ATOL and max(errs) <= BWD_RTOL):
        raise AssertionError(f"flash cross {shape}: forward err {err}, lse "
                             f"err {lse_err}, dq/dk/dv rel {errs}")
    dq, dk, dv = (torch.empty_like(x) for x in (qt, kt, vt))

    def fwd():
        return fa.flash_attention(q, k, v, scale=scale)

    def bwd():
        fa.flash_attention_bwd(qt, kt, vt, o, lse, dot, scale=scale, dq=dq,
                               dk=dk, dv=dv)

    ms, bwd_ms = _time_ms(fwd, iters=100), _time_ms(bwd, iters=100)
    fwd_whole, ((device_ms, seen),) = _once_a_call(fwd,
                                                   ("flash_fwd_kernel",))
    bwd_whole, split = _once_a_call(bwd, FLASH_BWD_KERNELS)
    if not (fwd_whole and bwd_whole):
        raise AssertionError(f"flash cross {shape}: the profiler saw "
                             f"forward {(device_ms, seen)}, backward "
                             f"{split}")
    plain_ms = _time_ms(lambda: fa.flash_attention_bhnd_reference(
        qt, kt, vt, scale=scale), iters=20)
    plain_bwd_ms = _time_ms(lambda: fa.flash_attention_bwd_reference(
        qt, kt, vt, dot, scale=scale), iters=20)
    qs, ks, vs = (x.contiguous().requires_grad_(True) for x in (qt, kt, vt))
    dos = dot.contiguous()

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, scale=scale)

    o_lib = F.scaled_dot_product_attention(qs, ks, vs, scale=scale)

    def library_bwd():
        return torch.autograd.grad(o_lib, (qs, ks, vs), dos,
                                   retain_graph=True)

    (fwd_bound, fwd_by), (bwd_bound, bwd_by) = _cross_bounds_ms(*shape)
    row = {"shape": list(shape), "max_abs_err": err,
           "max_abs_err_lse": lse_err, "rel_err_dq_dk_dv": errs,
           "max_abs_err_bwd": abs_err,
           "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
           "bound_ms": fwd_bound, "bound_by": fwd_by,
           "library_ms": _time_ms(library, iters=100),
           "library_device_ms": _device_ms(library, ""),
           "library_backend": _library_backend(library),
           "bwd_ms": bwd_ms, "bwd_device_ms": sum(t for t, _ in split),
           "bwd_device_ms_preprocess_main_convert": [t for t, _ in split],
           "bwd_plain_ms": plain_bwd_ms, "bwd_bound_ms": bwd_bound,
           "bwd_bound_by": bwd_by,
           "bwd_library_ms": _time_ms(library_bwd, iters=100),
           "bwd_library_device_ms": _device_ms(library_bwd, ""),
           "bwd_library_backend": _library_backend(library_bwd),
           "plan": fa.launch_plan(B, H, Nq, D, Nk=Nk)._asdict(),
           "bwd_plan": fa.launch_plan(B, H, Nq, D, Nk=Nk,
                                      backward=True)._asdict()}
    _say("kernel check flash_attention_cross", json.dumps(row))
    return row


def write_detr_data(workdir: str) -> str:
    """A synthetic COCO root at 512 px: ``train`` (DETR_TRAIN_N pictures)
    and ``validation`` (DETR_VAL_N, another seed)."""
    from vit_torch_tpu_torch.detection.coco_data import make_synthetic_coco
    root = os.path.join(workdir, "detr_coco")
    make_synthetic_coco(os.path.join(root, "train"), n_images=DETR_TRAIN_N,
                        size=DETR_SIZE, seed=0)
    make_synthetic_coco(os.path.join(root, "validation"),
                        n_images=DETR_VAL_N, size=DETR_SIZE, seed=1)
    return root


def _detr_want(train_steps: int, eval_batches: int):
    """Launches of DETR over Swin-T at 512 px: every Swin block takes B8
    (one core launch forward, one B6 backward with grad), every forward
    18 flash forwards, every train step 18 flash backwards."""
    forwards = train_steps + eval_batches
    return _want(flash_attention_fwd=DETR_FLASH * forwards,
                 flash_attention_bwd=DETR_FLASH * train_steps,
                 window_block_spatial=SWIN_T_DEPTH * forwards,
                 window_attention=SWIN_T_DEPTH * forwards,
                 window_attention_bwd=SWIN_T_DEPTH * train_steps)


def detr_train_through_cli(root: str, workdir: str):
    """Full-width DETR (hidden 256, 8 heads, 6 + 6 layers, FFN 2048, 100
    queries) over Swin-T at 512 px, bs8, one epoch of the synthetic train
    set and the bbox evaluation of the validation set through
    ``vit_torch_tpu_torch.cli.coco``: launch counts, the stats JSON (a
    finite loss, the 12 COCO numbers; AP itself is not gated: seeded
    weights, one epoch)."""
    from vit_torch_tpu_torch.cli import coco as cli_coco
    steps, evals = DETR_TRAIN_N // DETR_BS, DETR_VAL_N // DETR_BS
    want = _detr_want(steps, evals)
    fp = os.path.join(workdir, "detr_stats.json")
    _reset_counts()
    t0 = time.perf_counter()
    cli_coco.main(DETR_ARGS + ["--data_root", root, "--stats_fp", fp])
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    with open(fp) as f:
        record = json.load(f)
    logs = record["logs"]
    row = {"seconds": seconds, "launches": counts, "want": want,
           "telem": record["telem"],
           "train": logs[0]["train"] if logs else None,
           "bbox": logs[0]["val"].get("bbox") if logs else None}
    _say(json.dumps({"detr_train": row}))
    if counts != want:
        raise AssertionError(f"detr_train: kernel launches {counts} != "
                             f"{want}")
    if not (len(logs) == 1 and np.isfinite(logs[0]["train"]["loss_total"])
            and len(row["bbox"]) == 12
            and all(np.isfinite(v) for v in row["bbox"].values())):
        raise AssertionError(f"detr_train: bad stats {record}")
    return row


def _detr_setup(root: str, seed: int = 0, matcher: str = "host"):
    """A seeded full-width DETR over Swin-T at 512 px on the card, its
    trainer (AdamW, the flip on, ``matcher``) and one synthetic bs8
    batch."""
    import torch
    from vit_torch_tpu_torch.detection.coco_data import (CocoDetectionDataset,
                                                         CocoLoader)
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import DetectionTrainer
    ds = CocoDetectionDataset(os.path.join(root, "train", "data"),
                              os.path.join(root, "train", "labels.json"),
                              image_size=DETR_SIZE)
    batch = next(iter(CocoLoader(ds, DETR_BS, num_workers=0)))
    model = build_detr(DETRConfig(num_classes=ds.num_classes),
                       DETR_BACKBONE, DETR_SIZE, torch.bfloat16,
                       torch.Generator().manual_seed(seed), "cuda")
    trainer = DetectionTrainer(model, image_size=DETR_SIZE,
                               num_classes=ds.num_classes, augment=True,
                               matcher=matcher)
    return model, trainer, batch


def steady_state_detr(root: str, iters: int = 10):
    """The DETR train step at bs8 (flip, forward, costs on the card, the
    Hungarian solves on the host, 6 layers' set losses, backward, clip,
    AdamW) on the card: CUDA-event and host time over ``iters`` steps
    after warm-up (the step waits for the costs, so the two agree), the
    host's share (waiting for the costs; solving the 6 x 8 assignments),
    the launches per step, peak memory and a profile by kernel group with
    the device's idle share."""
    import torch
    model, trainer, batch = _detr_setup(root)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    _reset_counts()
    trainer.train_step(batch)
    per_step = _read_counts()
    trainer.host_ms = {"costs_wait": 0.0, "match": 0.0, "steps": 0}
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    smi = [_smi_sample()]
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        logs = trainer.train_step(batch)
    end.record()
    torch.cuda.synchronize()
    host_step_ms = 1e3 * (time.perf_counter() - t0) / iters
    smi.append(_smi_sample())
    host = trainer.host_ms
    row = {"arch": f"detr_{DETR_BACKBONE}", "image_size": DETR_SIZE,
           "bs": DETR_BS, "opt": "adamw", "iters": iters,
           "step_ms": start.elapsed_time(end) / iters,
           "host_step_ms": host_step_ms,
           "costs_wait_ms_per_step": host["costs_wait"] / host["steps"],
           "matcher_host_ms_per_step": host["match"] / host["steps"],
           "loss_total": float(logs["loss_total"]),
           "launches_per_step": per_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "smi_before_after": smi,
           "profile": _profile_calls(lambda: trainer.train_step(batch))}
    _say(json.dumps({"detr_step": row}))
    if per_step != _detr_want(1, 0):
        raise AssertionError(f"launches per DETR step {per_step}")
    if not np.isfinite(row["loss_total"]):
        raise AssertionError(f"DETR step loss {row['loss_total']}")
    return row


def _plain_flash(q, k, v, *, scale=None):
    """Attention on the plain version (differentiable through autograd),
    patched in for the kernel-vs-plain comparison of a DETR step."""
    from vit_torch_tpu_torch.ops import flash_attention as fa
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    return fa.flash_attention_bhnd_reference(qt, kt, vt,
                                             scale=scale).transpose(1, 2)


def _plain_detr():
    """Flash (every attention of the transformer) and the Swin window
    blocks on their plain versions."""
    from vit_torch_tpu_torch.ops import attention as attention_mod
    stack = _plain_window_blocks()
    stack.enter_context(mock.patch.object(attention_mod, "flash_attention",
                                          _plain_flash))
    return stack


def compare_detr_step_with_plain(root: str, matcher: str = "host",
                                 name: str = "detr_step_vs_plain"):
    """Loss and gradients of one bs8 DETR train step (no augmentation, the
    same drop-path masks, no optimizer step, the kernel forward's
    assignment for every run) on the kernels, on their plain versions in
    bf16, and on the plain versions in fp32, the reference.  The
    classifiers' bound (every relative gradient norm within
    STEP_GRAD_RTOL of the plain bf16 step) does not hold for this model:
    the plain bf16 step itself leaves a third of DETR's gradients more
    than STEP_GRAD_RTOL from the fp32 step (the deep decoder layers'
    self-attention q/k gradients by over 100%: dS = P (dP - Di) cancels
    over 100 queries and dO, V are bf16), so each bf16 step is held to the
    fp32 one: the loss within DETR_STEP_LOSS_RTOL, the whole gradient
    within STEP_GRAD_RTOL, and on the gradients bf16 can compute (those
    the plain bf16 step gets within STEP_GRAD_RTOL, at least half of
    them) the kernel step's median within STEP_GRAD_RTOL and none past
    DETR_STEP_GRAD_MAX.  Gradients zero in exact arithmetic (every key
    bias: softmax ignores a shift shared by all keys; the first decoder
    layer's self-attention, whose values are zero) are left out.  The
    classifiers' readings are printed beside them.  The first card run
    of Swin's B8 route and of flash with Nk != Nq under autograd in one
    model.  ``matcher="device"`` takes the assignment from the auction on
    the card (one launch) instead of the host solve."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import prep_targets
    from vit_torch_tpu_torch.models.layers import set_generator
    model, trainer, batch = _detr_setup(root, seed=1, matcher=matcher)
    ref = build_detr(DETRConfig(num_classes=model.config.num_classes),
                     DETR_BACKBONE, DETR_SIZE, torch.float32, device="cuda")
    ref.load_state_dict(model.state_dict())
    set_generator(ref, trainer.generator)
    b = trainer._batch(batch)
    x = normalize(b["image"], **trainer.norm)
    targets = prep_targets(b["labels"], b["boxes"], b["box_mask"],
                           b["mask"], DETR_SIZE)

    def forward(m):
        m.train()
        trainer.generator.manual_seed(7)          # the same drop-path masks
        return m(x)

    def loss_and_grads(m, out):
        m.zero_grad(set_to_none=True)
        loss, _ = trainer.losses(out, targets, assign)
        loss.backward()
        return loss.item(), {n: p.grad.detach().float().clone()
                             for n, p in m.named_parameters()
                             if p.grad is not None}

    _reset_counts()
    out = forward(model)
    assign = trainer.match(list(out["aux_outputs"]) + [out], targets)
    loss_k, grads_k = loss_and_grads(model, out)
    counts = _read_counts()
    with _plain_detr():
        loss_p, grads_p = loss_and_grads(model, forward(model))
        loss_r, grads_r = loss_and_grads(ref, forward(ref))
    if _read_counts() != counts:
        raise AssertionError("the plain DETR steps launched a kernel")
    if (counts != _detr_step_want(matcher)
            or not set(grads_k) == set(grads_p) == set(grads_r)):
        raise AssertionError(f"launches in the kernel DETR step {counts}")

    def rel(got, want, names):
        return {n: ((got[n] - want[n]).norm()
                    / want[n].norm().clamp_min(1e-30)).item() for n in names}

    def whole(got):
        return (torch.cat([(got[n] - grads_r[n]).flatten() for n in grads_r])
                .norm() / torch.cat([g.flatten() for g in grads_r.values()])
                .norm()).item()

    exact = [n for n, g in grads_r.items()
             if g.norm() > 0 and not n.endswith("k.bias")]
    k_ref, p_ref = rel(grads_k, grads_r, exact), rel(grads_p, grads_r, exact)
    k_p = rel(grads_k, grads_p, exact)
    able = [n for n in exact if p_ref[n] <= STEP_GRAD_RTOL]
    k_able = [k_ref[n] for n in able]
    worst = max(able, key=k_ref.get)
    row = {"arch": f"detr_{DETR_BACKBONE}", "bs": DETR_BS,
           "loss_kernel": loss_k, "loss_plain": loss_p, "loss_fp32": loss_r,
           "loss_rel_err_kernel_plain": [abs(loss_k - loss_r) / abs(loss_r),
                                         abs(loss_p - loss_r) / abs(loss_r)],
           "whole_grad_rel_err_kernel_plain": [whole(grads_k),
                                               whole(grads_p)],
           "median_grad_rel_err_kernel_plain": [
               float(np.median(list(k_ref.values()))),
               float(np.median(list(p_ref.values())))],
           "params": len(grads_r), "exact_nonzero": len(exact),
           "bf16_able": len(able),
           "able_median_max_kernel": [float(np.median(k_able)),
                                      max(k_able)],
           "able_worst_param": worst,
           "classifier_bounds_kernel_vs_plain": {
               "loss_abs_diff": abs(loss_k - loss_p),
               "max_grad_rel_err": max(k_p.values()),
               "over_step_grad_rtol": sum(v > STEP_GRAD_RTOL
                                          for v in k_p.values())},
           "plain_bf16_vs_fp32_over_step_grad_rtol": len(exact) - len(able),
           "launches": counts}
    _say(json.dumps({name: row}))
    if not (np.isfinite(loss_k)
            and row["loss_rel_err_kernel_plain"][0] <= DETR_STEP_LOSS_RTOL
            and row["whole_grad_rel_err_kernel_plain"][0] <= STEP_GRAD_RTOL
            and 2 * len(able) >= len(exact)
            and row["able_median_max_kernel"][0] <= STEP_GRAD_RTOL
            and row["able_median_max_kernel"][1] <= DETR_STEP_GRAD_MAX):
        raise AssertionError(
            f"DETR kernel step vs the fp32 step: {row} (limits loss "
            f"{DETR_STEP_LOSS_RTOL}, whole gradient and median "
            f"{STEP_GRAD_RTOL}, max {DETR_STEP_GRAD_MAX})")
    return row


def detr_w8a8_forward(root: str):
    """One full-width DETR eval forward at bs8 with ``VITX_W8A8`` off and
    on: under it every QLinear (input_proj, MHA q/k/v/out, FFN, Swin's
    MLPs) runs once (one Q2 launch, two Q1); the logits' cosine against
    the fp forward must exceed W8A8_MIN_COSINE; both forwards timed on
    CUDA events."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.models.layers import QLinear
    model, trainer, batch = _detr_setup(root, seed=2)
    model.eval()
    sites = sum(isinstance(m, QLinear) for m in model.modules())
    x = normalize(torch.as_tensor(batch["image"]).cuda(), **trainer.norm)
    out, counts, ms = {}, {}, {}
    for on in (False, True):
        with mock.patch.dict(os.environ, {"VITX_W8A8": "1" if on else ""}), \
                torch.inference_mode():
            _reset_counts()
            out[on] = model(x)["pred_logits"].float().cpu().numpy()
            torch.cuda.synchronize()
            counts[on] = _read_counts()
            ms[on] = _time_ms(lambda: model(x), iters=5)
    cos = _cosine(out[True], out[False])
    q = counts[True]
    row = {"arch": f"detr_{DETR_BACKBONE}", "bs": DETR_BS, "qlinear": sites,
           "launches_w8a8": {k: v for k, v in q.items() if v},
           "launches_fp": {k: v for k, v in counts[False].items() if v},
           "cosine": cos, "forward_ms_fp_w8a8": [ms[False], ms[True]]}
    _say(json.dumps({"detr_w8a8": row}))
    if (q["w8a8_gemm"] != sites or q["w8a8_quantize_rows"] != 2 * sites
            or counts[False]["w8a8_gemm"] != 0
            or q["flash_attention_fwd"] != DETR_FLASH
            or not np.isfinite(out[True]).all()
            or cos <= W8A8_MIN_COSINE):
        raise AssertionError(f"DETR W8A8: {row}")
    return row


def detr_phases(workdir: str):
    """Every DETR phase on one synthetic root; then (ROADMAP A10d) the
    auction kernel, the device-matcher step beside the host one, the bf16
    device step against the fp32 one, and the chunked training,
    checkpoints, resume and bundles through the CLI."""
    root = write_detr_data(workdir)
    return {"train": detr_train_through_cli(root, workdir),
            "step": steady_state_detr(root),
            "step_vs_plain": compare_detr_step_with_plain(root),
            "w8a8": detr_w8a8_forward(root),
            "auction": check_auction_kernel(root),
            "device_step": steady_state_detr_device(root),
            "device_step_vs_plain": compare_detr_step_with_plain(
                root, matcher="device", name="detr_device_step_vs_plain"),
            "scan_resume_bundle": detr_scan_resume_bundle(root, workdir)}


def write_frcnn_data(workdir: str) -> str:
    """A synthetic COCO root with keypoints at 512 px: ``train``
    (FRCNN_TRAIN_N pictures) and ``validation`` (FRCNN_VAL_N, another
    seed); every picture has a box whose keypoints lie inside it
    (``tests/test_torch_port_keypoint.py``)."""
    from vit_torch_tpu_torch.detection.coco_data import make_synthetic_coco
    root = os.path.join(workdir, "frcnn_coco")
    make_synthetic_coco(os.path.join(root, "train"), n_images=FRCNN_TRAIN_N,
                        size=FRCNN_SIZE, seed=0, keypoints=True)
    make_synthetic_coco(os.path.join(root, "validation"),
                        n_images=FRCNN_VAL_N, size=FRCNN_SIZE, seed=1,
                        keypoints=True)
    return root


def _frcnn_want(backbone: str, train_steps: int, eval_batches: int):
    """Launches of Faster R-CNN: none over ResNeXt (cuDNN and cuBLAS);
    over Swin-T at 512 px every block through B8 (one core launch a
    forward, one B6 a train step), as in DETR."""
    if backbone != DETR_BACKBONE:
        return _want()
    forwards = train_steps + eval_batches
    return _want(window_block_spatial=SWIN_T_DEPTH * forwards,
                 window_attention=SWIN_T_DEPTH * forwards,
                 window_attention_bwd=SWIN_T_DEPTH * train_steps)


def frcnn_through_cli(root: str, workdir: str, backbone: str,
                      keypoints: bool = False):
    """One epoch of the synthetic train set at bs8 and the evaluation of
    the validation set through ``cli.coco --head faster_rcnn`` (the JAX
    CLI's full settings): launch counts, epoch seconds, the 12 bbox
    numbers and, with ``keypoints``, the 10 keypoint numbers (finite; AP
    itself is not gated: seeded weights, one epoch)."""
    from vit_torch_tpu_torch.cli import coco as cli_coco
    name = ("kprcnn_train" if keypoints else "frcnn_swin_train"
            if backbone == DETR_BACKBONE else "frcnn_train")
    steps, evals = FRCNN_TRAIN_N // FRCNN_BS, FRCNN_VAL_N // FRCNN_BS
    want = _frcnn_want(backbone, steps, evals)
    fp = os.path.join(workdir, f"{name}.json")
    _reset_counts()
    t0 = time.perf_counter()
    cli_coco.main(FRCNN_ARGS + ["--backbone", backbone, "--data_root", root,
                                "--stats_fp", fp]
                  + (["--keypoints"] if keypoints else []))
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    with open(fp) as f:
        record = json.load(f)
    logs = record["logs"]
    val = logs[0]["val"] if logs else {}
    row = {"backbone": backbone, "seconds": seconds,
           "epoch_seconds": logs[0]["time"] if logs else None,
           "launches": counts, "want": want, "telem": record["telem"],
           "train": logs[0]["train"] if logs else None,
           "bbox": val.get("bbox"), "keypoints": val.get("keypoints")}
    _say(json.dumps({name: row}))
    if counts != want:
        raise AssertionError(f"{name}: kernel launches {counts} != {want}")
    sizes = {"bbox": 12, "keypoints": 10 if keypoints else None}
    if not (len(logs) == 1 and np.isfinite(logs[0]["train"]["loss_total"])
            and all((row[k] is None) if n is None else (
                len(row[k]) == n and all(np.isfinite(v)
                                         for v in row[k].values()))
                    for k, n in sizes.items())):
        raise AssertionError(f"{name}: bad stats {record}")
    return row


def _frcnn_setup(root: str, backbone: str = FRCNN_BACKBONE,
                 keypoints: bool = False, seed: int = 0):
    """A seeded full-width Faster R-CNN (Keypoint R-CNN with
    ``keypoints``) in bf16 on the card, its trainer (the flip on, the
    schema's keypoint swap) and the train set's first bs8 batch."""
    import torch
    from vit_torch_tpu_torch.detection.coco_data import (CocoDetectionDataset,
                                                         CocoLoader)
    from vit_torch_tpu_torch.detection.engine import FasterRCNNTrainer
    from vit_torch_tpu_torch.detection.faster_rcnn import (FasterRCNNConfig,
                                                           build_faster_rcnn)
    from vit_torch_tpu_torch.detection.keypoint import kp_flip_inds_from_names
    ds = CocoDetectionDataset(os.path.join(root, "train", "data"),
                              os.path.join(root, "train", "labels.json"),
                              image_size=FRCNN_SIZE,
                              load_keypoints=keypoints)
    batch = next(iter(CocoLoader(ds, FRCNN_BS, num_workers=0)))
    cfg = FasterRCNNConfig(num_classes=ds.num_classes,
                           image_size=FRCNN_SIZE,
                           num_keypoints=ds.num_keypoints)
    model = build_faster_rcnn(cfg, backbone, torch.bfloat16,
                              torch.Generator().manual_seed(seed), "cuda")
    trainer = FasterRCNNTrainer(
        model, cfg=cfg, lr=1e-4, augment=True,
        kp_flip_inds=kp_flip_inds_from_names(ds.kp_names) if keypoints
        else None)
    return model, trainer, batch


def _nms_loop(B: int, n: int, outputs: int, thresh: float):
    """The padded NMS at one of the step's shapes on random boxes of the
    512 px canvas (a fixed trip count: the data does not change its
    work): CUDA-event ms a call, its launches and device busy ms from the
    profiler."""
    import torch
    from vit_torch_tpu_torch.detection.boxes import nms_padded
    gen = torch.Generator().manual_seed(0)
    xy = torch.rand((B, n, 2), generator=gen) * 400
    boxes = torch.cat([xy, xy + 8 + 100 * torch.rand((B, n, 2),
                                                     generator=gen)],
                      -1).cuda()
    scores = torch.randn((B, n), generator=gen).cuda()
    events = _cuda_events(lambda: nms_padded(boxes, scores, thresh,
                                             outputs), iters=2)
    return {"shape": [B, n, outputs],
            "ms": _time_ms(lambda: nms_padded(boxes, scores, thresh,
                                              outputs), iters=5),
            "launches": sum(e.count for e in events) / 2,
            "device_busy_ms": sum(e.self_device_time_total
                                  for e in events) / 1e3 / 2}


def _step_syncs(trainer, batch):
    """Whether a train step reads the device before its loss terms are
    logged: the step under ``torch.cuda.set_sync_debug_mode("error")``;
    the message of the first synchronising call, or None."""
    import torch
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        trainer.train_step(batch)
        return None
    except RuntimeError as e:
        return str(e)[:200]
    finally:
        torch.cuda.set_sync_debug_mode("default")


def steady_state_frcnn(root: str, keypoints: bool, iters: int = 5):
    """The Faster R-CNN (Keypoint R-CNN) train step over resnext50_32x4d
    at 512 px bs8 (flip, forward, matching and sampling, losses,
    backward, clip, SGD): CUDA-event and host ms over ``iters`` steps
    after warm-up, the launches of one step (none of a hand kernel), peak
    memory, a profile by kernel group with the device's idle share, the
    padded NMS loop's ms, launches and share of the step (the RPN's 256
    outputs from 1000 candidates an image, and the decode's 100 from 256
    in eval), and whether the step synchronises before its loss read."""
    import torch
    model, trainer, batch = _frcnn_setup(root, keypoints=keypoints)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    _reset_counts()
    trainer.train_step(batch)
    per_step = _read_counts()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        logs = trainer.train_step(batch)
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / iters
    row = {"arch": f"{'kp' if keypoints else 'f'}rcnn_{FRCNN_BACKBONE}",
           "image_size": FRCNN_SIZE, "bs": FRCNN_BS, "opt": "sgd",
           "iters": iters, "step_ms": step_ms,
           "host_step_ms": 1e3 * (time.perf_counter() - t0) / iters,
           "loss_total": float(logs["loss_total"]),
           "launches_per_step": per_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": _profile_calls(lambda: trainer.train_step(batch))}
    cfg = trainer.cfg
    rpn = _nms_loop(FRCNN_BS, cfg.rpn_pre_nms_topk, cfg.num_proposals,
                    cfg.rpn_nms_thresh)
    row["nms_rpn"] = rpn
    row["nms_share_of_step"] = rpn["ms"] / step_ms
    row["nms_decode"] = _nms_loop(FRCNN_BS, cfg.num_proposals,
                                  cfg.detections, 0.5)
    row["syncs_before_loss_read"] = _step_syncs(trainer, batch)
    _say(json.dumps({"frcnn_step": row}))
    if per_step != _want():
        raise AssertionError(f"launches per Faster R-CNN step {per_step}")
    if not np.isfinite(row["loss_total"]):
        raise AssertionError(f"Faster R-CNN step loss {row['loss_total']}")
    del model, trainer
    torch.cuda.empty_cache()
    return row


def compare_frcnn_swin_with_plain(root: str):
    """Faster R-CNN over Swin-T at 512 px bs8 (bf16, eval mode: no
    drop-path), on the kernels and on the plain versions of the window
    blocks: the FPN maps and the RPN logits and deltas (max |diff| over
    max |plain|, within FRCNN_PLAIN_RTOL), and the backbone's gradients
    under one fixed upstream gradient on its four stage maps (relative
    norm of the whole and median per parameter, within STEP_GRAD_RTOL).
    A whole step is not compared: top-k and NMS choose other proposals
    once a logit moves by a rounding."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    model, trainer, batch = _frcnn_setup(root, backbone=DETR_BACKBONE,
                                         seed=1)
    model.eval()
    x = normalize(torch.as_tensor(batch["image"]).cuda(), **trainer.norm)
    gen = torch.Generator(device="cuda").manual_seed(3)
    upstream = None

    def run():
        nonlocal upstream
        model.zero_grad(set_to_none=True)
        maps = model.backbone(x)
        if upstream is None:
            upstream = [torch.randn(m.shape, generator=gen, device="cuda")
                        for m in maps]
        sum((m.float() * g).sum() for m, g in zip(maps, upstream)).backward()
        with torch.no_grad():
            feats = model.fpn([m.detach() for m in maps])
            logits, deltas = model.rpn(feats)
        grads = {n: p.grad.detach().float().clone()
                 for n, p in model.backbone.named_parameters()
                 if p.grad is not None}
        return [f.float() for f in feats] + [logits.float(),
                                             deltas.float()], grads

    _reset_counts()
    outs_k, grads_k = run()
    counts = _read_counts()
    with _plain_window_blocks():
        outs_p, grads_p = run()
    if _read_counts() != counts:
        raise AssertionError("the plain Faster R-CNN pass launched a kernel")
    want = _want(window_block_spatial=SWIN_T_DEPTH,
                 window_attention=SWIN_T_DEPTH,
                 window_attention_bwd=SWIN_T_DEPTH)
    if counts != want:
        raise AssertionError(f"launches in the kernel pass {counts}")
    out_err = [((k - p).abs().max() / p.abs().max()).item()
               for k, p in zip(outs_k, outs_p)]
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_p.items() if g.norm() > 0}
    whole = (torch.cat([(grads_k[n] - grads_p[n]).flatten() for n in rel])
             .norm() / torch.cat([grads_p[n].flatten() for n in rel])
             .norm()).item()
    worst = max(rel, key=rel.get)
    row = {"arch": f"frcnn_{DETR_BACKBONE}", "bs": FRCNN_BS,
           "fpn_rpn_rel_err": out_err, "whole_grad_rel_err": whole,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "max_grad_rel_err": rel[worst], "worst_param": worst,
           "params": len(rel), "launches": counts,
           "bounds": {"fpn_rpn": FRCNN_PLAIN_RTOL, "grad": STEP_GRAD_RTOL}}
    _say(json.dumps({"frcnn_vs_plain": row}))
    if not (max(out_err) <= FRCNN_PLAIN_RTOL and whole <= STEP_GRAD_RTOL
            and row["median_grad_rel_err"] <= STEP_GRAD_RTOL):
        raise AssertionError(f"Faster R-CNN over Swin, kernels vs plain: "
                             f"{row}")
    del model, trainer
    torch.cuda.empty_cache()
    return row


def frcnn_w8a8_forward(root: str):
    """One full-width Faster R-CNN eval forward over resnext50_32x4d at
    bs8 with ``VITX_W8A8`` off and on: under it box_fc1 and box_fc2 run
    Q2 once and Q1 twice each (activations, weight) at 2048 RoIs; the
    proposals are the same (the RPN is not quantised), the class logits'
    cosine against the fp forward above W8A8_MIN_COSINE; both forwards
    timed on CUDA events; then Q1 and Q2 at the two products' shapes
    held against their plain versions (``kernel check w8a8``)."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    model, trainer, batch = _frcnn_setup(root, seed=2)
    model.eval()
    x = normalize(torch.as_tensor(batch["image"]).cuda(), **trainer.norm)
    out, counts, ms = {}, {}, {}
    for on in (False, True):
        with mock.patch.dict(os.environ, {"VITX_W8A8": "1" if on else ""}), \
                torch.inference_mode():
            _reset_counts()
            o = model(x)
            out[on] = (o["cls_logits"].float().cpu().numpy(),
                       o["proposal_index"].cpu().numpy())
            torch.cuda.synchronize()
            counts[on] = _read_counts()
            ms[on] = _time_ms(lambda: model(x), iters=5)
    q = counts[True]
    row = {"arch": f"frcnn_{FRCNN_BACKBONE}", "bs": FRCNN_BS,
           "launches_w8a8": {k: v for k, v in q.items() if v},
           "launches_fp": {k: v for k, v in counts[False].items() if v},
           "same_proposals": bool((out[True][1] == out[False][1]).all()),
           "cosine": _cosine(out[True][0], out[False][0]),
           "forward_ms_fp_w8a8": [ms[False], ms[True]]}
    _say(json.dumps({"frcnn_w8a8": row}))
    if (q != _want(w8a8_gemm=2, w8a8_quantize_rows=4)
            or counts[False] != _want() or not row["same_proposals"]
            or not np.isfinite(out[True][0]).all()
            or row["cosine"] <= W8A8_MIN_COSINE):
        raise AssertionError(f"Faster R-CNN W8A8: {row}")
    del model, trainer
    torch.cuda.empty_cache()
    row["kernel_rows"] = [check_w8a8_kernels(shape, seed=100 + i)
                          for i, shape in enumerate(FRCNN_W8A8_SHAPES)]
    return row


def frcnn_phases(workdir: str):
    """Every Faster R-CNN phase on one synthetic root."""
    root = write_frcnn_data(workdir)
    return {"train": frcnn_through_cli(root, workdir, FRCNN_BACKBONE),
            "swin_train": frcnn_through_cli(root, workdir, DETR_BACKBONE),
            "kp_train": frcnn_through_cli(root, workdir, FRCNN_BACKBONE,
                                          keypoints=True),
            "step": steady_state_frcnn(root, keypoints=False),
            "kp_step": steady_state_frcnn(root, keypoints=True),
            "vs_plain": compare_frcnn_swin_with_plain(root),
            "w8a8": frcnn_w8a8_forward(root),
            "scan_bundle": frcnn_scan_bundle(root, workdir)}


# --------------------------------------------------------------------------
# DETR instance masks and panoptic (ROADMAP A10c)
# --------------------------------------------------------------------------

def _segm_setup(root: str, seed: int = 0):
    """A seeded full-width DETRSegm over Swin-T at 512 px in bf16 on the
    card, its trainer (AdamW, the flip on, the mask losses) and the train
    set's first bs8 batch with its gt masks."""
    import torch
    from vit_torch_tpu_torch.detection.coco_data import (CocoDetectionDataset,
                                                         CocoLoader)
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import DetectionTrainer
    ds = CocoDetectionDataset(os.path.join(root, "train", "data"),
                              os.path.join(root, "train", "labels.json"),
                              image_size=DETR_SIZE, load_masks=True)
    batch = next(iter(CocoLoader(ds, DETR_BS, num_workers=0)))
    model = build_detr(DETRConfig(num_classes=ds.num_classes),
                       DETR_BACKBONE, DETR_SIZE, torch.bfloat16,
                       torch.Generator().manual_seed(seed), "cuda",
                       masks=True)
    trainer = DetectionTrainer(model, image_size=DETR_SIZE,
                               num_classes=ds.num_classes, augment=True,
                               masks=True)
    return model, trainer, batch


def _segm_stats_row(name, record, seconds, counts, want):
    """The stats JSON of a mask run, checked: a finite loss with the mask
    losses, the 12 bbox and 12 segm numbers and PQ, SQ, RQ finite."""
    logs = record["logs"]
    val = logs[0]["val"] if logs else {}
    row = {"seconds": seconds,
           "epoch_seconds": logs[0]["time"] if logs else None,
           "launches": counts, "want": want, "telem": record["telem"],
           "train": logs[0]["train"] if logs else None,
           "bbox": val.get("bbox"), "segm": val.get("segm"),
           "panoptic": val.get("panoptic")}
    _say(json.dumps({name: row}))
    if counts != want:
        raise AssertionError(f"{name}: kernel launches {counts} != {want}")
    if not (len(logs) == 1 and all(np.isfinite(logs[0]["train"][k]) for k in
                                   ("loss_total", "loss_mask", "loss_dice"))
            and all(len(row[k] or {}) == 12 and all(
                np.isfinite(v) for v in row[k].values())
                for k in ("bbox", "segm"))
            and all(np.isfinite((row["panoptic"] or {}).get(k, np.nan))
                    for k in ("pq", "sq", "rq"))):
        raise AssertionError(f"{name}: bad stats {record}")
    return row


def segm_train_through_cli(root: str, workdir: str):
    """Full-width DETRSegm (DETR's settings and 8 mask heads) over Swin-T
    at 512 px, bs8, one epoch of the synthetic train set (polygon masks)
    and the bbox, segm and PQ evaluation of the validation set through
    ``cli.coco --masks``: the launches of the flash pair, B8, the core and
    B6 are DETR's (the mask branch runs no hand kernel); the stats JSON
    (AP and PQ themselves are not gated: seeded weights, one epoch)."""
    from vit_torch_tpu_torch.cli import coco as cli_coco
    want = _detr_want(DETR_TRAIN_N // DETR_BS, DETR_VAL_N // DETR_BS)
    fp = os.path.join(workdir, "segm_stats.json")
    _reset_counts()
    t0 = time.perf_counter()
    cli_coco.main(SEGM_ARGS + ["--data_root", root, "--stats_fp", fp])
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    with open(fp) as f:
        record = json.load(f)
    return _segm_stats_row("segm_train", record, seconds, counts, want)


def _sync_warnings(trainer, batch) -> list:
    """The synchronising calls of one train step, as
    ``torch.cuda.set_sync_debug_mode("warn")`` reports them."""
    import warnings
    import torch
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            trainer.train_step(batch)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return [str(w.message)[:120] for w in seen
            if "called a synchronizing" in str(w.message)]


def _mask_branch_ms(model, trainer, batch, iters: int = 5):
    """CUDA-event ms of the mask branch alone on the step's own inputs
    (the backbone's stage maps, the memory and the last decoder state,
    detached): the attention map, the stack and the conv head forward and
    backward with the mask losses, and the losses alone (forward and
    backward on the head's detached logits)."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.detection.engine import prep_targets
    from vit_torch_tpu_torch.detection.segmentation import mask_losses
    model.train()
    b = trainer._batch(batch)
    x = normalize(b["image"], **trainer.norm)
    targets = prep_targets(b["labels"], b["boxes"], b["box_mask"],
                           b["mask"], DETR_SIZE)
    with torch.no_grad():
        stages = model.backbone(x)
        out, memory, hs = model.detect(stages[-1])
    assign = trainer.match(list(out["aux_outputs"]) + [out], targets)
    params = [p for n, p in model.named_parameters()
              if n.startswith(("bbox_attention", "mask_head"))]

    def branch():
        pm = model.mask_logits(stages, memory, hs)
        ml = mask_losses(pm, b["gt_masks"], assign[-1], targets["box_mask"],
                         targets["mask"])
        torch.autograd.grad(ml["loss_mask"] + ml["loss_dice"], params)
        return pm

    pm = branch().detach().requires_grad_(True)

    def losses():
        ml = mask_losses(pm, b["gt_masks"], assign[-1], targets["box_mask"],
                         targets["mask"])
        torch.autograd.grad(ml["loss_mask"] + ml["loss_dice"], pm)

    return {"branch_fwd_bwd_ms": _time_ms(branch, iters=iters),
            "losses_fwd_bwd_ms": _time_ms(losses, iters=iters)}


def steady_state_segm(root: str, detr_step: dict, iters: int = 10):
    """The DETRSegm train step at bs8 (flip of images and gt masks,
    forward, the costs on the card, the solves on the host, the set
    losses of 6 layers and the mask losses of the last, backward, clip,
    AdamW): CUDA-event and host ms over ``iters`` steps after warm-up, the
    host's costs wait and solves, launches per step, peak memory, a
    profile by kernel group with the device's busy time and idle share,
    the mask branch's own ms (fwd + bwd; again with the upsampling's
    doublings gathered; the losses alone) and its share of the busy time, the busy time beside the DETR step's
    (``detr_step``), and the step's synchronising calls as
    ``set_sync_debug_mode("warn")`` reports them, against those of the
    same step without the mask losses (the host matcher's copies are the
    only reads of the device before the loss; the mask losses add
    none)."""
    import torch
    from vit_torch_tpu_torch.detection import segmentation
    model, trainer, batch = _segm_setup(root)
    for _ in range(3):
        trainer.train_step(batch)
    torch.cuda.synchronize()
    _reset_counts()
    trainer.train_step(batch)
    per_step = _read_counts()
    trainer.host_ms = {"costs_wait": 0.0, "match": 0.0, "steps": 0}
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    smi = [_smi_sample()]
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        logs = trainer.train_step(batch)
    end.record()
    torch.cuda.synchronize()
    host_step_ms = 1e3 * (time.perf_counter() - t0) / iters
    smi.append(_smi_sample())
    host = trainer.host_ms
    peak = torch.cuda.max_memory_allocated() / 1e9
    profile = _profile_calls(lambda: trainer.train_step(batch))
    branch = _mask_branch_ms(model, trainer, batch)
    # the mask head's doublings through resize_nearest's gather path (its
    # backward index_add_'s atomics) in place of F.interpolate's
    with mock.patch.object(segmentation, "resize_nearest",
                           lambda x, size: segmentation.gather_nearest(
                               x, *size)):
        branch["branch_fwd_bwd_ms_gather_only"] = _mask_branch_ms(
            model, trainer, batch)["branch_fwd_bwd_ms"]
    syncs = _sync_warnings(trainer, batch)
    trainer.masks = False
    syncs_without = _sync_warnings(trainer, batch)
    trainer.masks = True
    busy = profile["device_busy_ms"]
    row = {"arch": f"detr_segm_{DETR_BACKBONE}", "image_size": DETR_SIZE,
           "bs": DETR_BS, "opt": "adamw", "iters": iters,
           "step_ms": start.elapsed_time(end) / iters,
           "host_step_ms": host_step_ms,
           "costs_wait_ms_per_step": host["costs_wait"] / host["steps"],
           "matcher_host_ms_per_step": host["match"] / host["steps"],
           "loss_total": float(logs["loss_total"]),
           "loss_mask": float(logs["loss_mask"]),
           "loss_dice": float(logs["loss_dice"]),
           "launches_per_step": per_step, "peak_mem_gb": peak,
           "smi_before_after": smi, "profile": profile,
           "mask_branch": branch,
           "mask_branch_share_of_busy": branch["branch_fwd_bwd_ms"] / busy,
           "busy_ms_segm_detr": [busy,
                                 detr_step["profile"]["device_busy_ms"]],
           "syncs_per_step": len(syncs), "syncs": syncs,
           "syncs_per_step_without_mask_losses": len(syncs_without)}
    _say(json.dumps({"segm_step": row}))
    if per_step != _detr_want(1, 0):
        raise AssertionError(f"launches per DETRSegm step {per_step}")
    if not all(np.isfinite(row[k]) for k in ("loss_total", "loss_mask",
                                             "loss_dice")):
        raise AssertionError(f"DETRSegm step losses {row}")
    if len(syncs) > len(syncs_without):
        raise AssertionError(f"the mask losses read the device: {syncs} "
                             f"against {syncs_without}")
    del model, trainer
    torch.cuda.empty_cache()
    return row


def compare_segm_step_with_plain(root: str):
    """One bs8 DETRSegm train step (no augmentation, the same drop-path
    masks, the kernel forward's assignment for every run, no optimizer
    step) on the kernels, on their plain versions in bf16 and on the
    plain versions in fp32, the reference, as ``detr_step_vs_plain``
    does: the total loss within DETR_STEP_LOSS_RTOL of fp32 and each mask
    loss within SEGM_LOSS_RTOL; the ``pred_masks`` logits (max |diff| over
    max |fp32|), the mask branch's gradients (``bbox_attention`` and
    ``mask_head``) and the backbone's (relative norm of the group)
    within the larger of SEGM_RTOL and twice the plain bf16 step's own
    distance from fp32: the kernels may add no more than bf16's own
    rounding does."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.detection.detr import DETRConfig, build_detr
    from vit_torch_tpu_torch.detection.engine import prep_targets
    from vit_torch_tpu_torch.models.layers import set_generator
    model, trainer, batch = _segm_setup(root, seed=1)
    ref = build_detr(DETRConfig(num_classes=model.config.num_classes),
                     DETR_BACKBONE, DETR_SIZE, torch.float32, device="cuda",
                     masks=True)
    ref.load_state_dict(model.state_dict())
    set_generator(ref, trainer.generator)
    b = trainer._batch(batch)
    x = normalize(b["image"], **trainer.norm)
    targets = prep_targets(b["labels"], b["boxes"], b["box_mask"],
                           b["mask"], DETR_SIZE)

    def forward(m):
        m.train()
        trainer.generator.manual_seed(7)          # the same drop-path masks
        return m(x)

    def run(m, out):
        m.zero_grad(set_to_none=True)
        loss, logs = trainer.losses(out, targets, assign, b["gt_masks"])
        loss.backward()
        grads = {n: p.grad.detach().float().clone()
                 for n, p in m.named_parameters() if p.grad is not None}
        return ({"loss": loss.item(), "loss_mask": logs["loss_mask"].item(),
                 "loss_dice": logs["loss_dice"].item()},
                out["pred_masks"].detach().float(), grads)

    _reset_counts()
    out = forward(model)
    assign = trainer.match(list(out["aux_outputs"]) + [out], targets)
    kern = run(model, out)
    counts = _read_counts()
    with _plain_detr():
        plain = run(model, forward(model))
        fp32 = run(ref, forward(ref))
    if _read_counts() != counts:
        raise AssertionError("the plain DETRSegm steps launched a kernel")
    if counts != _detr_want(1, 0):
        raise AssertionError(f"launches in the kernel DETRSegm step "
                             f"{counts}")

    def group(grads, prefix):
        names = [n for n in fp32[2] if n.startswith(prefix)]
        got = torch.cat([grads[n].flatten() for n in names])
        want = torch.cat([fp32[2][n].flatten() for n in names])
        return ((got - want).norm() / want.norm()).item()

    groups = {"mask_branch": ("bbox_attention", "mask_head"),
              "backbone": ("backbone",)}
    row = {"arch": f"detr_segm_{DETR_BACKBONE}", "bs": DETR_BS,
           "losses_kernel_plain_fp32": [kern[0], plain[0], fp32[0]],
           "loss_rel_err_kernel_plain": {
               k: [abs(s[0][k] - fp32[0][k]) / abs(fp32[0][k])
                   for s in (kern, plain)] for k in fp32[0]},
           "pred_masks_rel_err_kernel_plain": [_rel_err(kern[1], fp32[1]),
                                               _rel_err(plain[1], fp32[1])],
           "grad_rel_err_kernel_plain": {
               g: [group(kern[2], p), group(plain[2], p)]
               for g, p in groups.items()},
           "launches": counts}
    _say(json.dumps({"segm_vs_plain": row}))
    rel = row["loss_rel_err_kernel_plain"]
    bounded = [row["pred_masks_rel_err_kernel_plain"]] + list(
        row["grad_rel_err_kernel_plain"].values())
    if not (np.isfinite(kern[0]["loss"])
            and rel["loss"][0] <= DETR_STEP_LOSS_RTOL
            and rel["loss_mask"][0] <= SEGM_LOSS_RTOL
            and rel["loss_dice"][0] <= SEGM_LOSS_RTOL
            and all(k <= max(SEGM_RTOL, 2 * p) for k, p in bounded)):
        raise AssertionError(
            f"DETRSegm kernel step vs the fp32 step: {row} (limits loss "
            f"{DETR_STEP_LOSS_RTOL}, mask losses {SEGM_LOSS_RTOL}, masks "
            f"and gradients max({SEGM_RTOL}, 2 x plain))")
    del model, ref, trainer
    torch.cuda.empty_cache()
    return row


def segm_eval(root: str):
    """The validation set's predictions of one seeded DETRSegm scored by
    ``evaluate(iou_types=("bbox", "segm"))`` with PQ and without (unpack,
    un-letterbox, encode; PQ paints and matches the segments too): the
    two segm and bbox APs must agree exactly.  Each setting's ``t_get`` /
    ``t_host`` / ``t_final``, the packed bytes copied a batch, and on the
    first batch the mask pixels that differ between the kernels' and the
    plain versions' forward (both post-processed on the card), and
    between the card's post-process and the CPU's of the same logits."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.detection.coco_data import (CocoDetectionDataset,
                                                         CocoLoader)
    from vit_torch_tpu_torch.detection.segmentation import postprocess_segm
    model, trainer, _ = _segm_setup(root, seed=3)
    val = CocoDetectionDataset(os.path.join(root, "validation", "data"),
                               os.path.join(root, "validation",
                                            "labels.json"),
                               image_size=DETR_SIZE)
    batches = list(CocoLoader(val, DETR_BS, num_workers=0))
    out, prof = {}, {}
    for panoptic in (True, False):
        _reset_counts()
        out[panoptic] = trainer.evaluate(
            batches, val.coco, iou_types=("bbox", "segm"),
            label_to_cat=val.label_to_cat, panoptic=panoptic)
        prof[panoptic] = dict(trainer.last_eval_profile,
                              launches=_read_counts())
    packed = trainer.predict(batches[0])["masks_packed"]
    x = normalize(torch.as_tensor(batches[0]["image"]).cuda(),
                  **trainer.norm)
    model.eval()
    with torch.inference_mode():
        logits = model(x)["pred_masks"]
        kern = postprocess_segm(logits, DETR_SIZE)
        cpu = postprocess_segm(logits.float().cpu(), DETR_SIZE)
        with _plain_detr():
            plain = postprocess_segm(model(x)["pred_masks"], DETR_SIZE)
    row = {"arch": f"detr_segm_{DETR_BACKBONE}", "bs": DETR_BS,
           "images": len(val), "with_pq": out[True],
           "without_pq": out[False],
           "profile_with_without_pq": [prof[True], prof[False]],
           "mask_bytes_per_batch": packed.numel() * packed.element_size(),
           "mask_pixels": kern.numel(),
           "pixels_differ_kernel_vs_plain": int((kern != plain).sum()),
           "pixels_differ_card_vs_cpu_postprocess": int(
               (kern.cpu() != cpu).sum())}
    _say(json.dumps({"segm_eval": row}))
    want = _detr_want(0, DETR_VAL_N // DETR_BS)
    if not (out[True]["segm"] == out[False]["segm"]
            and out[True]["bbox"] == out[False]["bbox"]
            and "panoptic" in out[True]
            and all(p["launches"] == want for p in prof.values())):
        raise AssertionError(f"segm_eval: with and without PQ disagree: "
                             f"{row}")
    del model, trainer
    torch.cuda.empty_cache()
    return row


def write_panoptic_data(workdir: str) -> str:
    """A synthetic panoptic root at 512 px (``make_synthetic_panoptic``:
    1-3 thing rectangles and one stuff segment a picture): ``train``
    (PAN_TRAIN_N pictures) and ``validation`` (PAN_VAL_N, another
    seed)."""
    from vit_torch_tpu_torch.detection.panoptic_data import (
        make_synthetic_panoptic)
    root = os.path.join(workdir, "panoptic")
    make_synthetic_panoptic(os.path.join(root, "train"),
                            n_images=PAN_TRAIN_N, size=DETR_SIZE, seed=0)
    make_synthetic_panoptic(os.path.join(root, "validation"),
                            n_images=PAN_VAL_N, size=DETR_SIZE, seed=1)
    return root


def panoptic_train_through_cli(root: str, workdir: str):
    """``cli.coco --panoptic_root`` at DETRSegm's full width: one epoch
    of the panoptic train split (segment masks cut from the PNGs) and the
    bbox, segm and PQ evaluation of the validation split on its
    instance-gt view; launches as DETR's; PQ, SQ and RQ printed."""
    from vit_torch_tpu_torch.cli import coco as cli_coco
    want = _detr_want(-(-PAN_TRAIN_N // DETR_BS), -(-PAN_VAL_N // DETR_BS))
    fp = os.path.join(workdir, "panoptic_stats.json")
    _reset_counts()
    t0 = time.perf_counter()
    cli_coco.main(DETR_ARGS + ["--panoptic_root", root, "--stats_fp", fp])
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    with open(fp) as f:
        record = json.load(f)
    if not record["info"]["masks"]:
        raise AssertionError("--panoptic_root did not turn --masks on")
    return _segm_stats_row("panoptic_train", record, seconds, counts, want)


def segm_w8a8_forward(root: str):
    """One full-width DETRSegm eval forward at bs8 with ``VITX_W8A8`` off
    and on: the transformer's QLinears take Q1/Q2 (one Q2 and two Q1
    launches each), the mask branch none; the cosines of the class logits
    and of the ``pred_masks`` logits against the fp forward must exceed
    W8A8_MIN_COSINE; both forwards timed on CUDA events."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.models.layers import QLinear
    model, trainer, batch = _segm_setup(root, seed=2)
    model.eval()
    sites = sum(isinstance(m, QLinear) for m in model.modules())
    branch = sum(isinstance(m, QLinear) for name, m in model.named_modules()
                 if name.startswith(("bbox_attention", "mask_head")))
    x = normalize(torch.as_tensor(batch["image"]).cuda(), **trainer.norm)
    out, counts, ms = {}, {}, {}
    for on in (False, True):
        with mock.patch.dict(os.environ, {"VITX_W8A8": "1" if on else ""}), \
                torch.inference_mode():
            _reset_counts()
            o = model(x)
            out[on] = {k: o[k].float().cpu().numpy()
                       for k in ("pred_logits", "pred_masks")}
            torch.cuda.synchronize()
            counts[on] = _read_counts()
            ms[on] = _time_ms(lambda: model(x), iters=5)
    cos = {k: _cosine(out[True][k], out[False][k]) for k in out[True]}
    q = counts[True]
    row = {"arch": f"detr_segm_{DETR_BACKBONE}", "bs": DETR_BS,
           "qlinear": sites, "qlinear_in_mask_branch": branch,
           "launches_w8a8": {k: v for k, v in q.items() if v},
           "launches_fp": {k: v for k, v in counts[False].items() if v},
           "cosine_logits_masks": [cos["pred_logits"], cos["pred_masks"]],
           "forward_ms_fp_w8a8": [ms[False], ms[True]]}
    _say(json.dumps({"segm_w8a8": row}))
    if (branch or q["w8a8_gemm"] != sites
            or q["w8a8_quantize_rows"] != 2 * sites
            or counts[False]["w8a8_gemm"] != 0
            or q["flash_attention_fwd"] != DETR_FLASH
            or not all(np.isfinite(v).all() for v in out[True].values())
            or min(cos.values()) <= W8A8_MIN_COSINE):
        raise AssertionError(f"DETRSegm W8A8: {row}")
    del model, trainer
    torch.cuda.empty_cache()
    return row


def segm_phases(workdir: str, detr_step: dict):
    """Every DETRSegm phase: on the DETR phases' synthetic COCO set
    (written again: polygon masks) and on a synthetic panoptic root."""
    root = write_detr_data(workdir)
    pan_root = write_panoptic_data(workdir)
    return {"train": segm_train_through_cli(root, workdir),
            "step": steady_state_segm(root, detr_step),
            "vs_plain": compare_segm_step_with_plain(root),
            "eval": segm_eval(root),
            "panoptic_train": panoptic_train_through_cli(pan_root, workdir),
            "w8a8": segm_w8a8_forward(root)}


# --------------------------------------------------------------------------
# The device matcher, chunked training, detection checkpoints and bundles
# (ROADMAP A10d)
# --------------------------------------------------------------------------

def _auction_bound_ms(L, B, Q, N) -> float:
    """The auction's bytes over 3.35 TB/s: the costs and the mask read
    once, the owners and iteration counts written once."""
    return (4 * (L * B * Q * N + B * N + L * B * Q + L * B)
            / H100_BYTES_PER_S * 1e3)


def _detr_step_costs(root: str):
    """The fp32 (L, B, Q, N) costs and the box mask of one train-mode
    forward of the seeded full-width DETR on a synthetic bs8 batch (the
    trainer's own cost computation)."""
    import torch
    from vit_torch_tpu_torch.data.augment import normalize
    from vit_torch_tpu_torch.detection.engine import prep_targets
    from vit_torch_tpu_torch.detection.matcher import cost_matrices
    model, trainer, batch = _detr_setup(root, seed=3, matcher="device")
    b = trainer._batch(batch)
    targets = prep_targets(b["labels"], b["boxes"], b["box_mask"],
                           b["mask"], DETR_SIZE)
    with torch.no_grad():
        model.train()
        out = model(normalize(b["image"], **trainer.norm))
        costs = torch.stack([
            cost_matrices(o["pred_logits"], o["pred_boxes"],
                          targets["labels"], targets["boxes_cxcywh"],
                          targets["box_mask"])
            for o in list(out["aux_outputs"]) + [out]])
    return costs, targets["box_mask"]


def check_auction_case(name: str, cost, mask):
    """The auction kernel against its plain version on the card, on the
    same fp32 costs: the assignments and iteration counts equal; every
    problem a permutation on its valid gts (min(n_valid, Q) of them);
    where every valid gt gets a query (n_valid <= Q), its total cost
    within n_valid · ε of the exact ``linear_sum_assignment`` (the ε-CS
    bound; fp32 sums, so 1e-4 of the optimum beside it).  With more valid
    gts than queries the auction stops at Q assigned, which ε-CS does not
    bound: its gap to the optimum is printed (``gap_over_q``).  The
    kernel timed on events and from the profiler, the plain version once
    (it reads its cond on the host every iteration)."""
    import torch
    from vit_torch_tpu_torch.detection.matcher import (
        auction_assign, auction_assign_reference, linear_sum_assignment)
    c = torch.as_tensor(cost, dtype=torch.float32, device="cuda")
    m = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
    owner, iters = auction_assign(c, m, return_iters=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, want_iters = auction_assign_reference(c, m, return_iters=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    equal = bool(torch.equal(owner, want) and torch.equal(iters, want_iters))
    o, cn, mn = owner.cpu().numpy(), c.cpu().numpy(), m.cpu().numpy()
    L, B, Q, N = cn.shape
    eps_frac = np.float32(1.0 / 500.0)
    perm_ok, gaps, slack, over_q = True, [], [], []
    for l in range(L):
        for b in range(B):
            valid = np.flatnonzero(mn[b] > 0)
            taken = o[l, b][o[l, b] >= 0]
            perm_ok &= (len(taken) == len(set(taken.tolist()))
                        == min(len(valid), Q)
                        and bool(np.isin(taken, valid).all()))
            if not len(valid):
                continue
            rows, cols = linear_sum_assignment(cn[l, b][:, valid])
            best = float(cn[l, b][rows, valid[cols]].astype(np.float64).sum())
            q = np.flatnonzero(o[l, b] >= 0)
            total = float(cn[l, b][q, o[l, b][q]].astype(np.float64).sum())
            benefit = np.where(mn[b][:, None] > 0, -cn[l, b].T, 0.0)
            eps = max(float(benefit.max() - benefit.min()), 1e-6) * eps_frac
            if len(valid) > Q:
                over_q.append(total - best)
                continue
            gaps.append(total - best)
            slack.append(float(len(valid) * eps)
                         + 1e-4 * max(1.0, abs(best)))
    within = all(g <= s for g, s in zip(gaps, slack)) and all(
        g >= -1e-4 * max(1.0, s) for g, s in zip(gaps, slack))

    def run():
        return auction_assign(c, m)

    its = iters.flatten().float()
    row = {"case": name, "shape": [L, B, Q, N],
           "n_valid": [int(v) for v in (mn > 0).sum(-1)],
           "equal": equal, "permutation": bool(perm_ok),
           "ecs_within": bool(within),
           "gap_max_over_bound": max((g / s for g, s in zip(gaps, slack)),
                                     default=0.0),
           "gap_over_q": max(over_q, default=None),
           "iters_min_median_max": [int(its.min()), float(its.median()),
                                    int(its.max())],
           "ms": _time_ms(run, iters=20),
           "device_ms": _device_ms(run, "auction_kernel"),
           "plain_ms": plain_ms, "bound_ms": _auction_bound_ms(L, B, Q, N),
           "bound_by": "bytes", "library_ms": None,
           "smem_bytes": 4 * (N * Q + 2 * Q + 4 * N)}
    _say("kernel check auction", json.dumps(row))
    if not (equal and perm_ok and within):
        raise AssertionError(f"auction {name}: {row}")
    return row


def check_auction_kernel(root: str):
    """The auction kernel at DETR's (6, 8, 100, 64): random costs with
    each image's n_valid drawn from 1-64 over a non-prefix mask, integer
    costs full of ties, more valid gts than queries (Q 40 of 64 gts), no
    valid gt, and the costs of a real DETR step."""
    rng = np.random.default_rng(0)
    L, B, Q, N = DETR_LAYERS, DETR_BS, AUCTION_Q, AUCTION_N
    mask = np.zeros((B, N), np.float32)
    for b in range(B):
        mask[b, rng.choice(N, int(rng.integers(1, N + 1)),
                           replace=False)] = 1.0
    step_costs, step_mask = _detr_step_costs(root)
    cases = [("random", rng.uniform(0, 4, (L, B, Q, N)), mask),
             ("integer_ties", rng.integers(0, 4, (L, B, Q, N)), mask),
             ("n_valid_over_q", rng.uniform(0, 4, (L, B, 40, N)),
              np.ones((B, N))),
             ("no_valid_gt", rng.uniform(0, 4, (L, B, Q, N)),
              np.zeros((B, N))),
             ("detr_step", step_costs, step_mask)]
    return [check_auction_case(*case) for case in cases]


def steady_state_detr_device(root: str, iters: int = 10):
    """The bs8 DETR train step with the device matcher and with the host
    matcher, one model each from one seed, timed in turns (device, host,
    host, device; ``iters`` steps a turn) in one call: step ms on events
    and on the host clock a turn, busy and idle from the profiler, peak
    memory, the launches a step (the flash pair, B8, the core, B6 and, on
    the device route, one auction), and whether the step reads the device
    before its loss (``_step_syncs``: none on the device route)."""
    import torch
    setups, rows = {}, {}
    for matcher in ("device", "host"):
        model, trainer, batch = _detr_setup(root, matcher=matcher)
        for _ in range(3):
            trainer.train_step(batch)
        torch.cuda.synchronize()
        _reset_counts()
        trainer.train_step(batch)
        per_step = _read_counts()
        setups[matcher] = (trainer, batch)
        rows[matcher] = {
            "step_ms": [], "host_step_ms": [],
            "launches_per_step": {k: v for k, v in per_step.items() if v},
            "syncs_before_loss_read": _step_syncs(trainer, batch),
            "want": {k: v for k, v in _detr_step_want(matcher).items()
                     if v}}
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    for matcher in ("device", "host", "host", "device"):
        trainer, batch = setups[matcher]
        t0 = time.perf_counter()
        start.record()
        for _ in range(iters):
            logs = trainer.train_step(batch)
        end.record()
        torch.cuda.synchronize()
        rows[matcher]["host_step_ms"].append(
            1e3 * (time.perf_counter() - t0) / iters)
        rows[matcher]["step_ms"].append(start.elapsed_time(end) / iters)
        rows[matcher]["loss_total"] = float(logs["loss_total"])
    for matcher, (trainer, batch) in setups.items():
        prof = _profile_calls(lambda: trainer.train_step(batch))
        rows[matcher].update(
            device_busy_ms=prof["device_busy_ms"],
            idle_share=prof["idle_share"],
            auction_ms=prof["groups_ms"].get("auction"))
    row = {"arch": f"detr_{DETR_BACKBONE}", "bs": DETR_BS, "iters": iters,
           "turns": ["device", "host", "host", "device"],
           # both models on the card at once
           "peak_mem_gb_both": torch.cuda.max_memory_allocated() / 1e9,
           **rows}
    _say(json.dumps({"detr_device_step": row}))
    for matcher, r in rows.items():
        if (r["launches_per_step"] != r["want"]
                or not np.isfinite(r["loss_total"])):
            raise AssertionError(f"DETR {matcher}-matcher step: {r}")
    if rows["device"]["syncs_before_loss_read"] is not None:
        raise AssertionError("the device-matcher step reads the device "
                             f"before its loss: {rows['device']}")
    del setups
    torch.cuda.empty_cache()
    return row


def _detr_step_want(matcher: str):
    return {**_detr_want(1, 0), "auction": int(matcher == "device")}


def _cpu_copy(obj):
    """A copy on the host of nested dicts and lists of tensors."""
    import torch
    if isinstance(obj, dict):
        return {k: _cpu_copy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_copy(v) for v in obj)
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True)
    return obj


def _val_pictures(root: str, n: int):
    """``n`` pictures at varied aspect ratios: the validation set's
    512 px pictures cropped to sizes from 3:1 to 1:3."""
    from PIL import Image
    data = os.path.join(root, "validation", "data")
    files = sorted(os.listdir(data))
    shapes = [(512, 512), (384, 512), (512, 384), (170, 510), (510, 170),
              (300, 450), (450, 300), (256, 256)]
    out = []
    for i in range(n):
        img = np.asarray(Image.open(os.path.join(data, files[i % len(files)]))
                         .convert("RGB"))
        h, w = shapes[i % len(shapes)]
        out.append(np.ascontiguousarray(img[:h, :w]))
    return out


def _match_detections(reply, raw, S: int):
    """Each served detection of one picture matched to a distinct query
    of the raw predictions: the same label, the score within
    SERVE_SCORE_RTOL of max |score|, the box within SERVE_BOX_RTOL of the
    image size.  Returns the unmatched count and the largest score and
    box differences of the matches."""
    tol_s = SERVE_SCORE_RTOL * float(np.abs(raw["scores"]).max())
    tol_b = SERVE_BOX_RTOL * S
    used, missed, ds, db = set(), 0, 0.0, 0.0
    for s, l, bx in zip(reply["scores"], reply["labels"], reply["boxes"]):
        d_s = np.abs(raw["scores"] - s)
        d_b = np.abs(raw["boxes"] - np.asarray(bx)).max(-1)
        # the closest query within both bounds (a seeded model gives many
        # queries one score)
        ok = [q for q in np.argsort(d_s / tol_s + d_b / tol_b)
              if q not in used and raw["labels"][q] == l
              and d_s[q] <= tol_s and d_b[q] <= tol_b]
        if not ok:
            missed += 1
            continue
        used.add(ok[0])
        ds, db = max(ds, float(d_s[ok[0]])), max(db, float(d_b[ok[0]]))
    return missed, ds, db


def serve_detr_bundle(root: str, bundle: str, bundle_w8a8: str, trainer):
    """The exported DETR bundle behind ``BundleServer`` on the card: a
    burst of SERVE_BURST one-picture requests at varied aspect ratios
    (p50 and p99 latency and the dispatch histogram from ``/stats``);
    one request of DETR_BS pictures, whose replies must match
    ``trainer.predict`` on the same letterboxed batch within the served
    bounds; the W8A8 bundle's Q1/Q2 launches on that batch and its
    scores' cosine against the fp bundle's."""
    import torch
    from vit_torch_tpu_torch.serving import (BundleServer, letterbox_images,
                                             load_bundle)
    pics = _val_pictures(root, SERVE_BURST)
    server = BundleServer(bundle, port=0, max_wait_ms=5.0, device="cuda")
    server.start()
    try:
        addr = server.address
        results = [None] * len(pics)

        def one(i):
            results[i] = _post(addr, {"images": [_png_b64(pics[i])],
                                      "score_threshold": 0.0})

        _post(addr, {"images": [_png_b64(pics[0])]})       # warm-up
        t0 = time.perf_counter()
        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(pics))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        burst_s = time.perf_counter() - t0
        eight = pics[:DETR_BS]
        status, body = _post(addr, {"images": [_png_b64(p) for p in eight],
                                    "score_threshold": 0.0})
        stats = _get(addr, "/stats")[1]
        batch = letterbox_images(eight, DETR_SIZE)
        raw = {k: v.float().cpu().numpy() if v.is_floating_point()
               else v.cpu().numpy()
               for k, v in trainer.predict(batch).items()}
        served_raw = server.model.predict_tree(batch)
        matches = [_match_detections(
            pred, {k: v[i] for k, v in raw.items()}, DETR_SIZE)
            for i, pred in enumerate(body["predictions"])]
        w8 = load_bundle(bundle_w8a8, device="cuda")
        _reset_counts()
        out8 = w8.predict_tree(batch)
        torch.cuda.synchronize()
        q_counts = {k: v for k, v in _read_counts().items() if v}
    finally:
        server.shutdown()
    row = {"requests": len(pics), "burst_seconds": burst_s,
           "statuses": sorted({r[0] for r in results} | {status}),
           "latency_ms": stats.get("latency_ms"),
           "dispatches": stats.get("dispatches"),
           "detections_per_reply": len(body["predictions"][0]["scores"]),
           "unmatched_max_score_box_diff": [
               sum(m[0] for m in matches), max(m[1] for m in matches),
               max(m[2] for m in matches)],
           "bundle_vs_predict_max_diff": {
               k: float(np.abs(served_raw[k].astype(np.float64)
                               - raw[k]).max())
               for k in ("scores", "boxes")},
           "w8a8_launches": q_counts,
           "w8a8_cosine_scores_boxes": [
               _cosine(out8["scores"], served_raw["scores"]),
               _cosine(out8["boxes"], served_raw["boxes"])]}
    _say(json.dumps({"detr_serve": row}))
    if not (row["statuses"] == [200]
            and all(len(r[1]["predictions"]) == 1 for r in results)
            and row["unmatched_max_score_box_diff"][0] == 0
            and q_counts.get("w8a8_gemm", 0) > 0
            and q_counts.get("w8a8_quantize_rows", 0) > 0
            and row["w8a8_cosine_scores_boxes"][0] > W8A8_MIN_COSINE):
        raise AssertionError(f"detr_serve: {row}")
    return row


def detr_scan_resume_bundle(root: str, workdir: str):
    """Through ``cli.coco`` at DETR's full width: a per-step epoch with
    the device matcher (``--scan 1``: one read a step; for the chunked
    epoch's time), then
    three calls: (1) ``--matcher device --scan 4 --epochs 1 --ckpt_dir
    d``; (2) ``--resume
    d --epochs 2 --scan 4 --ckpt_dir d --export_bundle b`` (epoch 1 only;
    the state it restored held bitwise against the checkpoint of epoch
    0); (3) under ``VITX_W8A8=1``, ``--resume d --epochs 2
    --export_bundle b8`` (no epoch left: exporting only).  Epoch seconds,
    the device reads an epoch (one a chunk), launches (one auction a
    step), checkpoint bytes, save and restore seconds; then the bundles
    served (:func:`serve_detr_bundle`)."""
    import torch
    from vit_torch_tpu_torch.cli import coco as cli_coco
    from vit_torch_tpu_torch.detection import engine
    from vit_torch_tpu_torch.detection.engine import DetectionTrainer
    ckpt = os.path.join(workdir, "detr_ckpt")
    bundle = os.path.join(workdir, "detr_bundle")
    bundle8 = os.path.join(workdir, "detr_bundle_w8a8")
    steps, evals = DETR_TRAIN_N // DETR_BS, DETR_VAL_N // DETR_BS
    argv = DETR_ARGS + ["--data_root", root, "--matcher", "device",
                        "--scan", str(SCAN_K)]
    reads = []
    read_logs = engine._read_logs
    captured = {}
    load = DetectionTrainer.load_checkpoint_state

    def counted(chunk):
        reads.append(len(chunk))
        return read_logs(chunk)

    def spy(self, state):
        load(self, state)
        captured.setdefault("trainers", []).append(self)
        captured.setdefault("restored", []).append(_cpu_copy(
            self.checkpoint_state(state["epoch"])))

    runs = {}
    with mock.patch.object(engine, "_read_logs", counted), \
            mock.patch.object(DetectionTrainer, "load_checkpoint_state", spy):
        for name, extra, env in (
                ("per_step", ["--scan", "1"], {}),
                ("scan_ckpt", ["--ckpt_dir", ckpt], {}),
                ("resume_export", ["--epochs", "2", "--resume", ckpt,
                                   "--ckpt_dir", ckpt, "--export_bundle",
                                   bundle], {}),
                ("w8a8_export", ["--epochs", "2", "--resume", ckpt,
                                 "--export_bundle", bundle8],
                 {"VITX_W8A8": "1"})):
            fp = os.path.join(workdir, f"detr_{name}.json")
            reads.clear()
            _reset_counts()
            t0 = time.perf_counter()
            with mock.patch.dict(os.environ, env):
                record = cli_coco.main(argv + extra + ["--stats_fp", fp])
            torch.cuda.synchronize()
            runs[name] = {"seconds": time.perf_counter() - t0,
                          "launches": {k: v for k, v in
                                       _read_counts().items() if v},
                          "reads": list(reads), "record": record}
    # run 2 restored epoch 0's checkpoint, run 3 epoch 1's
    for i, restored in enumerate(captured["restored"]):
        saved = torch.load(os.path.join(ckpt, str(i), "state.pt"),
                           map_location="cpu", weights_only=True)
        _same_state(restored, saved, f"restored epoch {i}")
    first, second = runs["scan_ckpt"], runs["resume_export"]
    log0, log1 = first["record"]["logs"], second["record"]["logs"]
    per_step = runs["per_step"]
    want1 = {k: v for k, v in {**_detr_want(steps, evals),
                               "auction": steps}.items() if v}
    # the export's bucket-1 predict is one more forward
    want2 = {k: v for k, v in {**_detr_want(steps, evals + 1),
                               "auction": steps}.items() if v}
    row = {"epoch_seconds": [log0[0]["time"], log1[0]["time"]],
           "per_step_epoch_seconds": per_step["record"]["logs"][0]["time"],
           "run_seconds": {k: r["seconds"] for k, r in runs.items()},
           "reads_per_epoch": [len(first["reads"]), len(second["reads"])],
           "per_step_reads": len(per_step["reads"]),
           "steps_per_read": first["reads"],
           "launches": {k: r["launches"] for k, r in runs.items()},
           "want": [want1, want2],
           "loss_total": [log0[0]["train"]["loss_total"],
                          log1[0]["train"]["loss_total"]],
           "epochs_logged": [[r["epoch"] for r in log0],
                             [r["epoch"] for r in log1]],
           "ckpt_bytes": os.path.getsize(os.path.join(ckpt, "0",
                                                      "state.pt")),
           "ckpt_save_seconds": log0[0].get("ckpt_seconds"),
           "ckpt_restore_seconds": second["record"]["resumed"]["seconds"],
           "restored_bitwise": len(captured["restored"]) == 2,
           "bundle_bytes": [os.path.getsize(os.path.join(b, "weights.pt"))
                            for b in (bundle, bundle8)],
           "w8a8_manifest": {k: runs["w8a8_export"]["record"][
               "export_bundle"][k] for k in ("w8a8", "w8a8_prequant")}}
    _say(json.dumps({"detr_scan_resume_bundle": row}))
    if not (first["launches"] == want1 and second["launches"] == want2
            and per_step["launches"] == want1
            and per_step["reads"] == [1] * steps
            and row["reads_per_epoch"] == [steps // SCAN_K] * 2
            and row["epochs_logged"] == [[0], [1]]
            and "initial" not in second["record"]
            and all(np.isfinite(row["loss_total"]))
            and row["w8a8_manifest"] == {"w8a8": True,
                                         "w8a8_prequant": True}):
        raise AssertionError(f"detr_scan_resume_bundle: {row}")
    row["serve"] = serve_detr_bundle(root, bundle, bundle8,
                                     captured["trainers"][0])
    return row


def frcnn_scan_bundle(root: str, workdir: str):
    """``cli.coco --head faster_rcnn --keypoints --scan 4 --export_bundle``
    over resnext50_32x4d at FRCNN_ARGS's settings (no hand kernel: no
    launch), one read a chunk; the Keypoint R-CNN bundle served over HTTP
    (a few pictures; ``keypoints`` in every reply)."""
    from vit_torch_tpu_torch.cli import coco as cli_coco
    from vit_torch_tpu_torch.detection import engine
    from vit_torch_tpu_torch.serving import BundleServer
    bundle = os.path.join(workdir, "kprcnn_bundle")
    fp = os.path.join(workdir, "kprcnn_scan.json")
    steps = FRCNN_TRAIN_N // FRCNN_BS
    reads = []
    read_logs = engine._read_logs

    def counted(chunk):
        reads.append(len(chunk))
        return read_logs(chunk)

    _reset_counts()
    t0 = time.perf_counter()
    with mock.patch.object(engine, "_read_logs", counted):
        record = cli_coco.main(FRCNN_ARGS + [
            "--backbone", FRCNN_BACKBONE, "--data_root", root, "--keypoints",
            "--scan", str(SCAN_K), "--export_bundle", bundle,
            "--stats_fp", fp])
    seconds = time.perf_counter() - t0
    counts = {k: v for k, v in _read_counts().items() if v}
    server = BundleServer(bundle, port=0, device="cuda")
    server.start()
    try:
        pics = _val_pictures(root, 4)
        status, body = _post(server.address, {
            "images": [_png_b64(p) for p in pics], "score_threshold": 0.0,
            "top_k": 10})
        stats = _get(server.address, "/stats")[1]
    finally:
        server.shutdown()
    preds = body.get("predictions", [])
    row = {"seconds": seconds, "epoch_seconds": record["logs"][0]["time"],
           "reads": reads, "launches": counts,
           "loss_total": record["logs"][0]["train"]["loss_total"],
           "status": status, "replies": len(preds),
           "keypoints_shape": (np.asarray(preds[0]["keypoints"]).shape
                               if preds and "keypoints" in preds[0]
                               else None),
           "latency_ms": stats.get("latency_ms"),
           "manifest_outputs": record["export_bundle"]["outputs"]}
    _say(json.dumps({"frcnn_scan_bundle": row}, default=list))
    if not (reads == [SCAN_K] * (steps // SCAN_K) and not counts
            and status == 200 and len(preds) == len(pics)
            and all("keypoints" in p and len(p["keypoints"]) == 10
                    for p in preds)
            and np.isfinite(row["loss_total"])):
        raise AssertionError(f"frcnn_scan_bundle: {row}")
    return row


# --------------------------------------------------------------------------
# the hand kernels at their tensor-parallel widths (ROADMAP A8)
# --------------------------------------------------------------------------

# the flash shapes the parallel modes give a rank of dino_vitb8 @224 at the
# global bs32: model=2 runs forward and backward over 6 of the 12 heads
# (models/layers.py:Attention, the tp_group branch), data=2 over 16 images
# a rank, pipe=2 over 8-image microbatches
TP_FLASH_SHAPES = [(32, 6, 785, 64), (16, 12, 785, 64), (8, 12, 785, 64)]
# a rank's Swin B8 chain (SwinBlock._forward_tp) at swin_base_384:
# (B, H, W, C, window, shift, local heads, model ranks).  At model=2
# stages 1-4 keep 2, 4, 8, 16 heads (Ca = 64, 128, 256, 512 < C); at
# model=4 stage 1 keeps one (Ca = 32: the qkv product's N = 96, proj's
# K = 32).  Stage 4's 12 x 12 map is one window, unshifted.  Each at bs8
# and at the Swin mode's PAR_SWIN_BS = 4 (half the windows)
TP_SWIN_CASES = [(B, H, W, C, 12, shift, heads, ranks)
                 for B in (8, 4)
                 for H, W, C, shift, heads, ranks in (
                     (96, 96, 128, 6, 2, 2), (48, 48, 256, 6, 4, 2),
                     (24, 24, 512, 6, 8, 2), (12, 12, 1024, 0, 16, 2),
                     (96, 96, 128, 6, 1, 4))]
# B12 over a model=2 rank's hidden columns at DeiT-base bs32 (Mlp._forward_tp
# under VITX_FUSED_MLP=1): 1536 of 3072, a zero output bias
TP_MLP_SHAPE = (6336, 768, 1536, 768, True)


def _tp_block_inputs(case, seed):
    """The full-width block inputs of ``_block_inputs`` cut as
    ``partition.apply_tensor_parallel`` cuts them for the last rank of the
    ``model`` axis: qkv's rows of its heads of each of q, k and v, proj's
    matching input columns, the bias table's head slice; proj's bias zero,
    as SwinBlock._forward_tp passes it."""
    import torch
    B, H, W, C, w, shift, heads, ranks = case
    d = _block_inputs(case[:6], seed)
    Ca, rank = heads * 32, ranks - 1
    cols = slice(rank * Ca, (rank + 1) * Ca)
    wq, bq = d["qkv"]
    return dict(x=d["x"], mask=d["mask"],
                qkv=(wq.view(3, C, C)[:, cols].reshape(3 * Ca, C)
                     .contiguous(),
                     bq.view(3, C)[:, cols].reshape(3 * Ca).contiguous()),
                proj=(d["proj"][0][:, cols].contiguous(),
                      torch.zeros(C, dtype=torch.bfloat16, device="cuda")),
                bias=d["bias"][rank * heads:(rank + 1) * heads].contiguous())


def _tp_block_bound_ms(case):
    """The rank's chain: 2 T (3 Ca C + C Ca) + 4 T N Ca operations; the map
    read and written once, its weights (bf16), its bias table and the mask
    (fp32)."""
    B, H, W, C, w, shift, heads, _ = case
    T, N, Ca = B * H * W, w * w, heads * 32
    return _bound(2 * T * 4 * C * Ca + 4 * T * N * Ca,
                  2 * T * C * 2 + 4 * C * Ca * 2 + heads * N * N * 4
                  + (shift > 0) * (H // w) * (W // w) * N * N * 4)


def check_tp_window_block(case, seed):
    """B8 over a rank's heads (row 8 at a tensor-parallel width) vs its plain
    version, forward and gradients: the chain's three launches (each
    one's device time), the window GEMM's two launches alone at their T, K
    and N (the gathered qkv at N = 3 Ca, the scattered proj at K = Ca),
    then the gradients through the Function (B6 in the backward, once) of
    the map, qkv's weight and bias, the bias table and proj's weight
    against autograd through the plain version."""
    import torch
    from vit_torch_tpu_torch.ops import gemm as gm
    from vit_torch_tpu_torch.ops import window_attention as wa
    from vit_torch_tpu_torch.ops import window_block as wb
    B, H, W, C, w, shift, heads, ranks = case
    Ca = heads * 32
    d = _tp_block_inputs(case, seed)
    kw = dict(num_heads=heads, window=w, shift=shift, scale=32 ** -0.5)
    args = (d["x"], *d["qkv"], d["bias"], d["mask"], *d["proj"])
    fn, ref_fn = wb.window_block_spatial, wb.window_block_spatial_reference
    out = fn(*args, **kw)
    torch.cuda.synchronize()
    ref = ref_fn(*args, **kw).float()
    abs_err = (out.float() - ref).abs().max().item()
    rel = abs_err / ref.abs().max().item()
    del ref, out
    if not rel <= BLOCK_RTOL:
        raise AssertionError(f"window_block_spatial at {case}: max abs err "
                             f"relative to max|plain| {rel} > {BLOCK_RTOL}")
    ms = _time_ms(lambda: fn(*args, **kw), iters=20)
    times = _launch_times(lambda: fn(*args, **kw), len(B8_LAUNCHES))
    device = [t for _, t in times]
    plain_ms = _time_ms(lambda: ref_fn(*args, **kw), iters=3)
    bound_ms, bound_by = _tp_block_bound_ms(case)
    launch_ms = dict(zip(B8_LAUNCHES, device))
    gemm = check_window_gemm(
        case[:6], d, launch_ms, label="_tp",
        products=(("qkv", C, 3 * Ca, gm.EPI_BIAS, True, False),
                  ("proj", Ca, C, gm.EPI_BIAS, False, True)))
    # the gradients: every input the model trains (proj's zero bias is a
    # constant there)
    gen = torch.Generator(device="cuda").manual_seed(5500 + seed)
    dout = torch.randn(d["x"].shape, generator=gen, device="cuda",
                       dtype=torch.bfloat16)
    x, wq, bq, bias, wp = (t.detach().clone().requires_grad_(True) for t in (
        d["x"], *d["qkv"], d["bias"], d["proj"][0]))
    wrt = [x, wq, bq, bias, wp]
    gargs = (x, wq, bq, bias, d["mask"], wp, d["proj"][1])
    before = wa.window_attention_bwd.launches
    got = torch.autograd.grad(fn(*gargs, **kw), wrt, dout)
    torch.cuda.synchronize()
    if wa.window_attention_bwd.launches != before + 1:
        raise AssertionError(f"window_block_spatial grad at {case} did not "
                             f"launch B6 once")
    want = torch.autograd.grad(ref_fn(*gargs, **kw), wrt, dout)
    grel = [((g.float() - r.float()).abs().max()
             / r.float().abs().max().clamp_min(1e-30)).item()
            for g, r in zip(got, want)]
    finite = all(torch.isfinite(g).all().item() for g in got)
    del got, want
    if not (finite and max(grel) <= BLOCK_GRAD_RTOL):
        raise AssertionError(f"window_block_spatial grads at {case}: error "
                             f"relative to max|plain| {grel} (limit "
                             f"{BLOCK_GRAD_RTOL})")
    fwd_bwd_ms = _time_ms(lambda: torch.autograd.grad(
        fn(*gargs, **kw), wrt, dout), iters=5)
    row = {"case": list(case), "Ca": Ca, "max_abs_err": abs_err,
           "max_rel_err": rel, "ms": ms,
           "device_ms": None if None in device else sum(device),
           "launch_device_ms": launch_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "grad_rel_err_x_wqkv_bqkv_bias_wproj": grel,
           "fwd_bwd_ms": fwd_bwd_ms,
           "gemm_T_K_N_device_ms_err": [
               [p["launch"], p["T"], p["K"], p["N"], p["device_ms"],
                p["max_rel_err"]] for p in gemm["products"]]}
    _say("kernel check window_block_spatial_tp", json.dumps(row))
    return {"block": row, "gemm": gemm}


def tp_width_checks():
    """Every hand kernel a tensor-parallel rank launches, at the widths the
    parallel modes give it, against its plain version under the limits of
    the full-width checks: flash forward and backward at each
    TP_FLASH_SHAPES shape, the B8 chain at each TP_SWIN_CASES width (with
    the window GEMM's launches and the gradients through B6), the window
    core and B6 alone at those widths (a rank's heads are a model of
    C = Ca), B12 over half the hidden columns with a zero output bias
    (forward and gradients)."""
    out = {"flash_fwd": [check_flash_kernel(s, seed=40 + i)
                         for i, s in enumerate(TP_FLASH_SHAPES)],
           "flash_bwd": [check_flash_bwd_kernel(s, seed=45 + i)
                         for i, s in enumerate(TP_FLASH_SHAPES)],
           "blocks": [check_tp_window_block(c, seed=50 + i)
                      for i, c in enumerate(TP_SWIN_CASES)]}
    local = [(B, H, W, heads * 32, w, shift)
             for B, H, W, C, w, shift, heads, _ in TP_SWIN_CASES]
    out["core"] = [check_window_attention(c, seed=60 + i)
                   for i, c in enumerate(local)]
    out["core_bwd"] = [check_window_attention_bwd(c, seed=70 + i)
                       for i, c in enumerate(local)]
    out["mlp"] = check_fused_mlp(TP_MLP_SHAPE, seed=80, zero_out_bias=True)
    out["mlp_grads"] = check_fused_mlp_grads(TP_MLP_SHAPE, seed=81,
                                             zero_out_bias=True)
    return out


def _tp_width_rows(tp, full):
    """The ``tp_widths`` entries of the kernels line: each kernel's rows at
    the tensor-parallel widths (shape, ms, plain ms, bound, error) beside
    the full-width row's ms (``full``: kernel name -> its head row)."""
    def flash(r):
        return {"shape": r["shape"], "ms": r["ms"],
                "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
                "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}

    rows = {
        "flash_attention_fwd": [flash(r) for r in tp["flash_fwd"]],
        "flash_attention_bwd": [{**flash(r), "max_rel_err":
                                 max(r["rel_err_dq_dk_dv"])}
                                for r in tp["flash_bwd"]],
        "window_block_spatial": [
            {"case": b["block"]["case"], "Ca": b["block"]["Ca"],
             "ms": b["block"]["ms"], "device_ms": b["block"]["device_ms"],
             "plain_ms": b["block"]["plain_ms"],
             "bound_ms": b["block"]["bound_ms"],
             "max_rel_err": b["block"]["max_rel_err"],
             "grad_max_rel_err": max(
                 b["block"]["grad_rel_err_x_wqkv_bqkv_bias_wproj"]),
             "fwd_bwd_ms": b["block"]["fwd_bwd_ms"]} for b in tp["blocks"]],
        "window_gemm": [
            {"case": b["block"]["case"], "launch": p["launch"], "T": p["T"],
             "K": p["K"], "N": p["N"], "ms": p["device_ms"],
             "plain_ms": p["plain_ms"], "bound_ms": p["bound_ms"],
             "max_rel_err": p["max_rel_err"],
             "library_device_ms": p["library_device_ms"]}
            for b in tp["blocks"] for p in b["gemm"]["products"]],
        "window_attention": [
            {"tp_case": c, "shape": r["shape"], "ms": r["ms"],
             "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"], "max_abs_err": r["max_abs_err"]}
            for c, r in zip(TP_SWIN_CASES, tp["core"])],
        "window_attention_bwd": [
            {"tp_case": c, "shape": r["shape"], "ms": r["ms"],
             "device_ms": r["device_ms"], "plain_ms": r["plain_ms"],
             "bound_ms": r["bound_ms"],
             "max_rel_err": max(r["rel_err_dq_dk_dv"]),
             "rel_err_dbias": r["rel_err_dbias"]}
            for c, r in zip(TP_SWIN_CASES, tp["core_bwd"])],
        "fused_mlp": [{
            "shape": tp["mlp"]["shape"], "zero_out_bias": True,
            "ms": tp["mlp"]["ms"], "device_ms": tp["mlp"]["device_ms"],
            "plain_ms": tp["mlp"]["plain_ms"],
            "bound_ms": tp["mlp"]["bound_ms"],
            "max_rel_err": tp["mlp"]["max_rel_err"],
            "grad_max_rel_err": max(tp["mlp_grads"]["grad_rel_err"]),
            "fwd_bwd_ms": tp["mlp_grads"]["fwd_bwd_ms"]}]}
    for name, full_row in full.items():
        for r in rows[name]:
            r["full_width"] = full_row
    return rows


# --------------------------------------------------------------------------
# parallelism (ROADMAP A8)
# --------------------------------------------------------------------------

# the resume phase's one-batch epoch (no augmentation, no dropout), one
# epoch; MESH_ITERS steady-state steps are timed on each trainer.  The
# weights after it are held to the resume phase's bounds against the run
# without --mesh (RESUME_ATOL, RESUME_UPDATE_RTOL: the flash backward's dQ
# atomics flip the sign of near-zero gradients, and AdamW's first update
# is +-lr an element); the losses to the bf16 step's STEP_LOSS_ATOL (the
# val loss after that update moved by 6.2e-4 on an H100)
MESH_ARGS = RESUME_ARGS + ["--epoch", "1"]
MESH_ITERS = 6
# two ranks on one card (in data=2 16 images each of the single-process
# step's bs32)
DP_RANKS, DP_STEPS = 2, 3


def _mesh_want():
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    depth = VIT_CONFIGS[ARCH].depth
    return _want(flash_attention_fwd=2 * depth, flash_attention_bwd=depth)


def _full_weights(trainer):
    """The single-process state dict of a trainer (laid out or not)."""
    if trainer.layout is not None:
        from vit_torch_tpu_torch.parallel.api import full_state
        return full_state(trainer.model, None, trainer.layout)[0]
    return {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}


def _step_batch(seed: int = 0, bs: int = TRAIN_BS, size: int = IMAGE_SIZE):
    import torch
    gen = torch.Generator().manual_seed(seed)
    images = torch.randint(0, 256, (bs, size, size, 3), generator=gen,
                           dtype=torch.uint8)
    labels = torch.randint(0, 10, (bs,), generator=gen)
    return (images.cuda(), labels.cuda(), torch.ones(bs).cuda())


def _steady_ms(trainer, batch, iters: int = MESH_ITERS):
    """A train step's ms on events and the peak memory over it (GB)."""
    import torch
    trainer.model.train()
    torch.cuda.reset_peak_memory_stats()
    ms = _time_ms(lambda: trainer.train_step(*batch), iters)
    return ms, torch.cuda.max_memory_allocated() / 1e9


def mesh_world1(workdir: str):
    """``mesh_dp_world1`` and ``mesh_fsdp_world1``: cli.main without a
    mesh, with ``--mesh data=1`` and with ``--mesh data=1 --fsdp`` over
    one world-1 NCCL group each; launches, losses, weights, step ms."""
    import torch
    import torch.distributed as dist
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    init = VisionModelZoo.get_model(
        ARCH, classifier=[512, 10], image_size=IMAGE_SIZE, device="cpu",
        generator=torch.Generator().manual_seed(0)).model.state_dict()
    runs = {}
    for mode, extra in (("plain", []), ("dp", ["--mesh", "data=1"]),
                        ("fsdp", ["--mesh", "data=1", "--fsdp"])):
        # keep each world-1 group until its steps are timed
        with mock.patch.object(cli_main.dist, "destroy_process_group",
                               lambda *a, **k: None):
            trainer, counts, seconds = _cli_trainer(
                MESH_ARGS + extra, f"{workdir}/mesh_{mode}.json",
                f"mesh_{mode}", _mesh_want(), augment_off=True)
        with open(f"{workdir}/mesh_{mode}.json") as f:
            stats = json.load(f)
        info = {"seconds": seconds, "launches": counts,
                "losses": [stats[s][0]["loss"] for s in ("train", "val")],
                "weights": _full_weights(trainer)}
        if mode == "plain":     # AdamW's first moment: 0.1 of the gradient
            opt = trainer.optimizer
            info["exp_avg"] = {n: opt.state[p]["exp_avg"].float().cpu()
                               for n, p in trainer.model.named_parameters()
                               if p in opt.state}
        if trainer.layout is not None:
            info["backend"] = dist.get_backend()
            if dist.get_backend() != "nccl":
                raise AssertionError(f"--mesh on CUDA formed a "
                                     f"{dist.get_backend()} group")
            if mode == "fsdp":
                # over one rank FSDP shards nothing, as in the JAX package
                from torch.distributed.tensor import DTensor
                info["fsdp_params"] = sum(
                    isinstance(p, DTensor)
                    for p in trainer.model.parameters())
                if info["fsdp_params"]:
                    raise AssertionError(f"--fsdp over one rank sharded "
                                         f"{info['fsdp_params']} tensors")
        info["step_ms"], info["peak_gb"] = _steady_ms(trainer, _step_batch())
        if trainer.layout is not None:
            dist.destroy_process_group()
        runs[mode] = info
        # _cli_trainer's recording subclass keeps each trainer in a
        # reference cycle: collect it, or its state (1.4 GB at dino_vitb8)
        # counts in the next mode's peak
        del trainer
        gc.collect()
        torch.cuda.empty_cache()
    out = {}
    plain = runs["plain"]
    plain["init"] = init
    for mode in ("dp", "fsdp"):
        r = runs[mode]
        row = {"launches": r["launches"],
               **_against_plain(r["losses"], r["weights"], plain),
               "backend": r["backend"],
               "step_ms_mesh_plain": [r["step_ms"], plain["step_ms"]],
               "peak_gb_mesh_plain": [r["peak_gb"], plain["peak_gb"]],
               "seconds_mesh_plain": [r["seconds"], plain["seconds"]]}
        if mode == "fsdp":
            row["fsdp_params"] = r["fsdp_params"]
        name = f"mesh_{mode}_world1"
        _say(json.dumps({name: row}))
        if r["launches"] != plain["launches"]:
            raise AssertionError(f"{name}: launches {r['launches']} != the "
                                 f"plain trainer's {plain['launches']}")
        if not row["within_limits"]:
            raise AssertionError(f"{name}: losses or weights past their "
                                 f"bounds: {row}")
        out[name] = row
    return out, plain


def _against_plain(losses, weights, plain, exp_avg=None):
    """The losses and weights of a run of MESH_ARGS against ``plain``'s
    (``mesh_world1``'s run without --mesh, with its ``init`` weights and
    AdamW first moments): losses to STEP_LOSS_ATOL, every weight to
    RESUME_ATOL and the update's distance to RESUME_UPDATE_RTOL of its
    norm.  Given the run's first moments (``exp_avg``, by name), each is
    held to STEP_GRAD_RTOL of the plain one's norm (one step: a tenth of
    the gradient), and the update's distance is taken over the elements
    whose first moments agree in sign: AdamW's first step moves an element
    by about lr times its gradient's sign, so an element whose gradient
    is near zero moves by 2 lr the other way when rounding flips that
    sign (the flipped share is reported beside the whole distance)."""
    loss_diff = max(abs(a - b) for a, b in zip(losses, plain["losses"]))
    want, init = plain["weights"], plain["init"]
    keys = [k for k, v in want.items() if v.is_floating_point()]
    max_abs = max(float((weights[k].float() - want[k].float()).abs().max())
                  for k in keys)
    update = sum(float(((want[k] - init[k]).float() ** 2).sum())
                 for k in keys) ** 0.5
    out = {"losses_mesh_plain": [losses, plain["losses"]],
           "loss_max_diff": loss_diff, "weights_max_abs_diff": max_abs}
    agree, moment_rel = {}, {}
    if exp_avg is not None:
        for k, m in exp_avg.items():
            ref = plain["exp_avg"][k]
            agree[k] = m.sign() == ref.sign()
            moment_rel[k] = float((m - ref).norm()
                                  / ref.norm().clamp_min(1e-30))
    diff_sq = {k: (weights[k] - want[k]).float() ** 2 for k in keys}
    diff = sum(float(d.sum()) for d in diff_sq.values()) ** 0.5
    gated = sum(float(d[agree[k]].sum()) if k in agree else float(d.sum())
                for k, d in diff_sq.items()) ** 0.5
    out["update_rel_diff"] = diff / update
    ok = (loss_diff <= STEP_LOSS_ATOL and max_abs <= RESUME_ATOL
          and gated / update <= RESUME_UPDATE_RTOL)
    if exp_avg is not None:
        worst = max(moment_rel, key=moment_rel.get)
        flipped = sum(int((~a).sum()) for a in agree.values())
        out.update(update_rel_diff_signs_agree=gated / update,
                   flipped_share=flipped / sum(a.numel()
                                               for a in agree.values()),
                   exp_avg_rel_max=[worst, moment_rel[worst]],
                   exp_avg_rel_median=float(np.median(
                       list(moment_rel.values()))))
        ok = ok and moment_rel[worst] <= STEP_GRAD_RTOL
    out.update(limits=[STEP_LOSS_ATOL, RESUME_ATOL, RESUME_UPDATE_RTOL]
               + ([STEP_GRAD_RTOL] if exp_avg is not None else []),
               within_limits=ok)
    return out


# the parallel modes that one card runs (two ranks share cuda:0 over gloo:
# multihost.dist_backend takes it where the local ranks outnumber the
# cards), spawned once; each mode forms a fresh group on a port of its
# own, takes DP_STEPS steps of one global batch and is held against the
# single-process steps (STEP_LOSS_ATOL, STEP_GRAD_RTOL): (name, --mesh,
# arch).  The four ViT modes share _step_batch's bs32, so that one
# single-process dino_vitb8 run is their reference; Swin has one of its
# own at PAR_SWIN_BS.  The tensor-parallel ViT also runs cli.main as
# torchrun starts it (_par_cli)
PAR_MODES = (("data", "data=2", ARCH), ("tp_vit", "model=2", ARCH),
             ("seq_vit", "seq=2", ARCH), ("pipe_vit", "pipe=2", ARCH),
             ("tp_swin", "model=2", SWIN_ARCH))
PIPE_MICROBATCHES = 4
PAR_SWIN_BS = 4
# seconds the parent waits for the two ranks to run every mode (about 80
# on an H100 host)
PAR_TIMEOUT = 480


def _par_want(name: str):
    """One rank's launches over DP_STEPS train steps of mode ``name``,
    from the block counts: a data or tensor-parallel ViT rank runs every
    block, flash forward and backward once each (TP over 6 of 12 heads);
    the ring's attention is einsums (no kernel, as in JAX); a pipeline
    stage runs its depth / 2 blocks once a microbatch; a tensor-parallel
    Swin rank runs every block through B8 over its heads (the core once)
    and B6 in the backward, two window-GEMM launches a B8."""
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    depth = VIT_CONFIGS[ARCH].depth
    flash = {"data": depth, "tp_vit": depth, "seq_vit": 0,
             "pipe_vit": depth // DP_RANKS * PIPE_MICROBATCHES}
    if name in flash:
        return _want(flash_attention_fwd=flash[name] * DP_STEPS,
                     flash_attention_bwd=flash[name] * DP_STEPS)
    blocks = sum(SWIN_CONFIGS[SWIN_ARCH].depths) * DP_STEPS
    return _want(window_attention=blocks, window_attention_bwd=blocks,
                 window_block_spatial=blocks)


def _dp_trainer(device, mesh=None, arch: str = ARCH,
                image_size: int = IMAGE_SIZE, pipe_microbatches: int = 0):
    import torch
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.trainer import Trainer
    zm = VisionModelZoo.get_model(
        arch, classifier=[512, 10], image_size=image_size,
        dtype=torch.bfloat16, device=device,
        generator=torch.Generator().manual_seed(0))
    return Trainer(zm, epochs=1, lr=1e-4, opt="adamw", seed=0, mesh=mesh,
                   augment_fn=lambda g, x: x.float() / 255.0,
                   print_progress=False, pipe_microbatches=pipe_microbatches)


def _dp_steps(trainer, batch, grads_fn=None, on_first=None):
    """DP_STEPS steps: losses, the first step's gradients (after the
    all-reduce; ``grads_fn`` gathers them to the single-process layout),
    the later steps' ms; ``on_first`` runs after the first step."""
    import torch
    losses, grads, ms = [], None, []
    for i in range(DP_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m = trainer.train_step(*batch)
        losses.append((m["loss_sum"] / m["count"]).item())
        ms.append(1e3 * (time.perf_counter() - t0))
        if i == 0:
            grads = grads_fn() if grads_fn else {
                n: p.grad.float().cpu()
                for n, p in trainer.model.named_parameters()}
            if on_first:
                on_first()
    return {"losses": losses, "grads": grads, "step_ms": ms[1:]}


def _count_collectives() -> dict:
    """Count, in this process, every collective and point-to-point call and
    the bytes of the tensors it is handed: {kind: [calls, bytes]}.  Both
    the ``torch.distributed`` names the port calls and the module globals
    that torch's own helpers call are wrapped, so a ``batch_isend_irecv``
    op counts once."""
    import torch
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    counts: dict = {}

    def nbytes(x):
        if isinstance(x, torch.Tensor):
            return x.numel() * x.element_size()
        return sum(nbytes(t) for t in x) if isinstance(x, (list, tuple)) \
            else 0

    for name, kind in (("all_reduce", "all_reduce"),
                       ("broadcast", "broadcast"),
                       ("all_gather", "all_gather"), ("isend", "send"),
                       ("send", "send"), ("irecv", "recv"),
                       ("recv", "recv")):
        def counted(*a, _fn=getattr(c10d, name), _kind=kind, **k):
            c = counts.setdefault(_kind, [0, 0])
            c[0] += 1
            c[1] += nbytes(a[0] if a else next(iter(k.values())))
            return _fn(*a, **k)

        setattr(c10d, name, counted)
        setattr(dist, name, counted)
    return counts


def _par_cli(rank: int, workdir: str):
    """The tensor-parallel ViT through its entry point, as torchrun starts
    it: ``cli.main --mesh model=2 --device cuda --ckpt_dir`` on the resume
    phase's one-batch epoch; then the rank's weights gathered to the
    single-process layout (``api.full_state``), which the parent holds
    against the checkpoint."""
    import torch.distributed as dist
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.parallel.api import full_state
    argv = MESH_ARGS + ["--mesh", "model=2", "--device", "cuda",
                        "--ckpt_dir", os.path.join(workdir, "tp_vit_ckpt")]
    # keep the group the CLI formed until the weights are gathered
    with mock.patch.object(cli_main.dist, "destroy_process_group",
                           lambda *a, **k: None):
        trainer, counts, seconds = _cli_trainer(
            argv, os.path.join(workdir, "tp_vit_cli.json"), "tp_vit_cli",
            _mesh_want(), augment_off=True, read_stats=rank == 0)
    weights = full_state(trainer.model, None, trainer.layout)[0]
    res = {"launches": counts, "seconds": seconds,
           "backend": dist.get_backend(),
           "weights": weights if rank == 0 else None,
           "trainable": trainer.layout.trainable}
    dist.barrier()
    dist.destroy_process_group()
    return res


def _par_mode(name: str, spec: str, arch: str, collectives: dict,
              rank: int):
    """One mode on this rank: a fresh group (MASTER_PORT), the trainer laid
    out over ``spec``, DP_STEPS steps of this rank's part of the global
    batch; the launches over them, the first step's gradients gathered to
    the single-process layout (rank 0), the collectives' calls and bytes
    over the later steps."""
    import torch
    import torch.distributed as dist
    from vit_torch_tpu_torch.parallel.api import _all_reduce_flat, full_grads
    from vit_torch_tpu_torch.parallel.multihost import setup_mesh
    t0 = time.perf_counter()
    mesh, device, _ = setup_mesh(spec, torch.device("cuda"))
    swin = arch == SWIN_ARCH
    trainer = _dp_trainer(
        device, mesh, arch, SWIN_SIZE if swin else IMAGE_SIZE,
        PIPE_MICROBATCHES if name == "pipe_vit" else 0)
    batch = _step_batch(bs=PAR_SWIN_BS, size=SWIN_SIZE) if swin \
        else _step_batch()
    _reset_counts()
    collectives.clear()
    res = _dp_steps(trainer, tuple(trainer.layout.shard(t) for t in batch),
                    lambda: full_grads(trainer.model, trainer.layout),
                    collectives.clear)
    res.update(launches=_read_counts(), backend=dist.get_backend(),
               device=str(device),
               collectives={k: list(v) for k, v in collectives.items()})
    if name == "data":
        grads = [p.grad for p in trainer.model.parameters()]
        res["allreduce_ms"] = _time_ms(lambda: _all_reduce_flat(
            grads, trainer.layout.replica_group, 1), 3, warmup=1)
        res["grad_bytes"] = sum(g.numel() * g.element_size() for g in grads)
    if rank:
        res["grads"] = None
    dist.barrier()
    dist.destroy_process_group()
    res["seconds"] = time.perf_counter() - t0
    return res


def _par_rank(rank: int, ports, workdir: str) -> None:
    """One of the two ranks: every mode of PAR_MODES in turn, each on its
    own port (the tensor-parallel ViT's CLI run on one more); each mode's
    result saved for the parent."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(DP_RANKS),
                      LOCAL_RANK=str(rank), MASTER_ADDR="localhost",
                      LOCAL_WORLD_SIZE=str(DP_RANKS))
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    collectives = _count_collectives()
    ports = iter(ports)
    for name, spec, arch in PAR_MODES:
        if name == "tp_vit":
            os.environ["MASTER_PORT"] = str(next(ports))
            torch.save(_par_cli(rank, workdir),
                       os.path.join(workdir, f"par_tp_vit_cli_r{rank}.pt"))
        os.environ["MASTER_PORT"] = str(next(ports))
        torch.save(_par_mode(name, spec, arch, collectives, rank),
                   os.path.join(workdir, f"par_{name}_r{rank}.pt"))
        gc.collect()
        torch.cuda.empty_cache()


def _check_tp_cli(workdir: str, plain):
    """``tp_vit_cli``: both ranks' launches against the one-batch epoch's;
    the checkpoint the CLI wrote loaded strictly into a single-process
    model, whose every tensor must equal the rank's gathered weights; its
    losses (rank 0's stats), weights and AdamW first moments held to
    ``plain``'s, the same run without --mesh (``mesh_world1``), by
    ``_against_plain``."""
    import torch
    from vit_torch_tpu_torch.checkpoint.ckpt_io import restore_checkpoint
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    runs = [torch.load(os.path.join(workdir, f"par_tp_vit_cli_r{r}.pt"),
                       weights_only=False) for r in range(DP_RANKS)]
    gathered = runs[0]["weights"]
    model = VisionModelZoo.get_model(
        ARCH, classifier=[512, 10], image_size=IMAGE_SIZE,
        device="cpu").model
    ckpt = restore_checkpoint(os.path.join(workdir, "tp_vit_ckpt"))
    model.load_state_dict(ckpt["model"], strict=True)
    loaded = model.state_dict()
    names = runs[0]["trainable"]
    exp_avg = {names[i]: v["exp_avg"].float()
               for i, v in ckpt["optimizer"]["state"].items()}
    differ = [k for k, v in gathered.items()
              if not torch.equal(loaded[k], v)]
    with open(os.path.join(workdir, "tp_vit_cli.json")) as f:
        stats = json.load(f)
    row = {"mesh": "model=2", "backend": runs[0]["backend"],
           "seconds_by_rank": [r["seconds"] for r in runs],
           "launches_by_rank": [r["launches"] for r in runs],
           "want": _mesh_want(), "tensors": len(gathered),
           "tensors_differing_from_checkpoint": differ,
           "keys_equal": sorted(gathered) == sorted(loaded),
           **_against_plain([stats[s][0]["loss"] for s in ("train", "val")],
                            loaded, plain, exp_avg)}
    _say(json.dumps({"tp_vit_cli_two_ranks_one_card": row}))
    if differ or not row["keys_equal"] or any(
            r["launches"] != row["want"] for r in runs):
        raise AssertionError(f"tp_vit_cli_two_ranks_one_card: {row}")
    if not row["within_limits"]:
        raise AssertionError(f"tp_vit_cli_two_ranks_one_card: losses or "
                             f"weights past their bounds: {row}")
    return row


def parallel_modes_one_card(workdir: str, plain):
    """The five modes of PAR_MODES as two spawned ranks on cuda:0 (one
    spawn), each held against its single-process steps (the CLI run
    against ``plain``, ``mesh_world1``'s run): ``<mode>`` lines
    with the mode's seconds, step ms, the collectives' calls and bytes a
    step and the backend, each rank's launches beside the expected ones;
    ``dp_two_ranks_one_card`` keeps its keys.  A rank that exits non-zero,
    a launch count off, a loss or gradient past its bound fails the
    run."""
    import multiprocessing

    import torch
    from vit_torch_tpu_torch.parallel.multihost import free_port
    gc.collect()
    torch.cuda.empty_cache()
    ctx = multiprocessing.get_context("spawn")
    ports = [free_port() for _ in range(len(PAR_MODES) + 1)]
    procs = [ctx.Process(target=_par_rank, args=(r, ports, workdir))
             for r in range(DP_RANKS)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    for p in procs:
        p.join(max(1.0, PAR_TIMEOUT - (time.perf_counter() - t0)))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    seconds = time.perf_counter() - t0
    if codes != [0] * DP_RANKS:
        raise AssertionError(f"parallel modes: rank exit codes {codes} "
                             f"after {seconds:.1f} s")
    out = {"spawn_seconds": seconds,
           "tp_vit_cli": _check_tp_cli(workdir, plain)}
    singles = {
        ARCH: _dp_steps(_dp_trainer(torch.device("cuda")), _step_batch()),
        SWIN_ARCH: _dp_steps(
            _dp_trainer(torch.device("cuda"), arch=SWIN_ARCH,
                        image_size=SWIN_SIZE),
            _step_batch(bs=PAR_SWIN_BS, size=SWIN_SIZE))}
    for name, spec, arch in PAR_MODES:
        runs = [torch.load(os.path.join(workdir, f"par_{name}_r{r}.pt"),
                           weights_only=False) for r in range(DP_RANKS)]
        got, single = runs[0], singles[arch]
        loss_diff = max(abs(a - b) for a, b in zip(got["losses"],
                                                   single["losses"]))
        rel = {n: float((got["grads"][n] - g).norm()
                        / g.norm().clamp_min(1e-30))
               for n, g in single["grads"].items()}
        worst = max(rel, key=rel.get)
        want = _par_want(name)
        row = {"mesh": spec, "arch": arch,
               "bs": PAR_SWIN_BS if arch == SWIN_ARCH else TRAIN_BS,
               "ranks": DP_RANKS, "device": got["device"],
               "backend": got["backend"],
               "seconds_by_rank": [r["seconds"] for r in runs],
               "losses_mode_single": [got["losses"], single["losses"]],
               "loss_max_diff": loss_diff, "grad_rel_max": [worst, rel[worst]],
               "grad_rel_median": float(np.median(list(rel.values()))),
               "limits": [STEP_LOSS_ATOL, STEP_GRAD_RTOL],
               "step_ms_mode_single": [got["step_ms"], single["step_ms"]],
               "launches_by_rank": [r["launches"] for r in runs],
               "want": want,
               # [calls, bytes] a step by kind, over the steps after the
               # first, on each rank
               "collectives_per_step_by_rank": [
                   {k: [c / (DP_STEPS - 1), b / (DP_STEPS - 1)]
                    for k, (c, b) in r["collectives"].items()}
                   for r in runs]}
        if name == "data":      # the DP phase's line and keys
            row.update(losses_dp_single=row["losses_mode_single"],
                       step_ms_dp_single=row["step_ms_mode_single"],
                       seconds=got["seconds"],
                       allreduce_ms=got["allreduce_ms"],
                       allreduce_bytes=got["grad_bytes"])
            line = "dp_two_ranks_one_card"
        else:
            line = f"{name}_two_ranks_one_card"
        _say(json.dumps({line: row}))
        odd = sorted(set(got["grads"]) ^ set(single["grads"]))
        if odd:
            raise AssertionError(f"{line}: the gathered gradients' names "
                                 f"differ from the single process's: {odd}")
        if any(r["launches"] != want for r in runs):
            raise AssertionError(f"{line}: launches {row['launches_by_rank']}"
                                 f" != {want}")
        if not (loss_diff <= STEP_LOSS_ATOL and rel[worst] <= STEP_GRAD_RTOL):
            raise AssertionError(f"{line} past its bounds: {row}")
        out[name] = row
    return out


def parallel_phases(workdir: str):
    out, plain = mesh_world1(workdir)
    out.update(parallel_modes_one_card(workdir, plain))
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from vit_torch_tpu_torch.ops import _build

    device_name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    _say(f"device {device_name} | count {torch.cuda.device_count()} | torch "
         f"{torch.__version__} cuda {torch.version.cuda} | {smi}")

    # each phase group's seconds, printed before the kernels line
    phase_s, mark = {}, [time.perf_counter()]

    def done(group: str) -> None:
        now = time.perf_counter()
        phase_s[group] = now - mark[0]
        mark[0] = now

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
    cross_rows = [check_flash_cross(shape, seed=i)
                  for i, shape in enumerate(DETR_FLASH_SHAPES)]

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
    done("build_and_kernel_checks")
    tp = tp_width_checks()
    done("tp_width_checks")

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
    done("dino_vitb8")

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
    done("swin")

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
    done("cait")

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
    done("attention_blocks")

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
    done("deit_and_b7")

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
    done("conv_families")
    extra_paths = lifecycle_and_data_extras()
    done("lifecycle_and_data_extras")

    w8a8_ptxas = ptxas_gate("w8a8", _build.LOGS.get("w8a8", ""))
    auction_ptxas = ptxas_gate("auction", _build.LOGS.get("auction", ""))
    w8a8_rows = [check_w8a8_kernels(shape, seed=i)
                 for i, shape in enumerate(W8A8_SHAPES)]
    with tempfile.TemporaryDirectory() as workdir:
        w8a8_serve = serve_w8a8(workdir)
    w8a8_families = w8a8_every_family()
    done("w8a8")
    with tempfile.TemporaryDirectory() as workdir:
        detr = detr_phases(workdir)
    done("detr")
    with tempfile.TemporaryDirectory() as workdir:
        frcnn = frcnn_phases(workdir)
    done("frcnn")
    with tempfile.TemporaryDirectory() as workdir:
        segm = segm_phases(workdir, detr["step"])
    done("segm")

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
            "lineareval": lineareval["flash_attention_fwd"],
            **{p: c["flash_attention_fwd"] for p, c in extra_paths.items()},
            "detr_train": detr["train"]["launches"]["flash_attention_fwd"],
            "segm_train": segm["train"]["launches"]["flash_attention_fwd"],
            "panoptic_train": segm["panoptic_train"]["launches"][
                "flash_attention_fwd"]},
        "detr_launches_per_step": detr["step"]["launches_per_step"][
            "flash_attention_fwd"],
        "segm_launches_per_step": segm["step"]["launches_per_step"][
            "flash_attention_fwd"],
        "detr_shape_ms_device_plain_library_libdevice_bound": [
            [r["shape"], r["ms"], r["device_ms"], r["plain_ms"],
             r["library_ms"], r["library_device_ms"], r["bound_ms"]]
            for r in cross_rows],
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
            "lineareval": lineareval["flash_attention_bwd"],
            **{p: c["flash_attention_bwd"] for p, c in extra_paths.items()},
            "detr_train": detr["train"]["launches"]["flash_attention_bwd"],
            "segm_train": segm["train"]["launches"]["flash_attention_bwd"],
            "panoptic_train": segm["panoptic_train"]["launches"][
                "flash_attention_bwd"]},
        "detr_launches_per_step": detr["step"]["launches_per_step"][
            "flash_attention_bwd"],
        "segm_launches_per_step": segm["step"]["launches_per_step"][
            "flash_attention_bwd"],
        "detr_shape_ms_device_plain_library_libdevice_bound": [
            [r["shape"], r["bwd_ms"], r["bwd_device_ms"], r["bwd_plain_ms"],
             r["bwd_library_ms"], r["bwd_library_device_ms"],
             r["bwd_bound_ms"]] for r in cross_rows],
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
            "launches_by_path": {
                **{p: c[kernel] for p, c in swin_paths.items()},
                "detr_train": detr["train"]["launches"][kernel],
                "frcnn_swin_train": frcnn["swin_train"]["launches"][kernel],
                "segm_train": segm["train"]["launches"][kernel],
                "panoptic_train": segm["panoptic_train"]["launches"][
                    kernel]},
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
        "launches_by_path": {
            **{p: c["window_gemm"] for p, c in swin_paths.items()},
            "detr_train": detr["train"]["launches"]["window_gemm"],
            "frcnn_swin_train": frcnn["swin_train"]["launches"][
                "window_gemm"],
            "segm_train": segm["train"]["launches"]["window_gemm"],
            "panoptic_train": segm["panoptic_train"]["launches"][
                "window_gemm"]},
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
    # W8A8's two kernels: numbers at dino_vitb8 @224 bs32 fc1 (T = 25,120,
    # K = 768, N = 3,072), every shape beside them; launches from the W8A8
    # serve's HTTP run (the slice's main path)
    head = next(r for r in w8a8_rows if r["shape"] == [25120, 768, 3072])
    for kernel, key, replaces in (
            ("w8a8_quantize_rows", "q1", "vit_torch_tpu/ops/quant.py:68"),
            ("w8a8_gemm", "q2", "vit_torch_tpu/ops/quant.py:93")):
        kernels.append({
            "name": kernel, "route": "cuda",
            "source": "vit_torch_tpu_torch/csrc/w8a8.cu",
            "replaces": replaces,
            "launches": w8a8_serve["launches_http"][kernel],
            "max_abs_err": max(r[key]["max_abs_err"] for r in w8a8_rows),
            "ms": head[key]["ms"], "device_ms": head[key]["device_ms"],
            "plain_ms": head[key]["plain_ms"],
            "bound_ms": head[key]["bound_ms"],
            "bound_by": head[key]["bound_by"],
            "library_ms": head[key]["library_ms"],
            "shape": head["shape"], "ptxas": w8a8_ptxas,
            "launches_per_dispatch": w8a8_serve["launches_per_dispatch"][
                kernel],
            "ms_device_plain_library_bound_by_shape": [
                [r["shape"], r[key]["ms"], r[key]["device_ms"],
                 r[key]["plain_ms"], r[key]["library_ms"],
                 r[key]["bound_ms"]] for r in w8a8_rows],
            # Faster R-CNN's box head (box_fc1, box_fc2) at bs8 x 256 RoIs
            "frcnn_launches_per_eval_forward": frcnn["w8a8"][
                "launches_w8a8"][kernel],
            "frcnn_ms_device_plain_library_bound_bf16linear_by_shape": [
                [r["shape"], r[key]["ms"], r[key]["device_ms"],
                 r[key]["plain_ms"], r[key]["library_ms"],
                 r[key]["bound_ms"], r["q2"]["bf16_linear_ms"]]
                for r in frcnn["w8a8"]["kernel_rows"]]})
    kernels[-2]["bound_share_plan_by_shape"] = [
        [r["shape"], r["q1"]["bound_share"], r["q1"]["plan"]]
        for r in w8a8_rows + frcnn["w8a8"]["kernel_rows"]]
    kernels[-1]["library"] = "torch._int_mm + the same rescale (cuBLASLt)"
    kernels[-1]["max_ulps"] = max(max(r["q2"]["max_ulps_bf16_fp32"])
                                  for r in w8a8_rows)
    kernels[-1]["bf16_linear_ms_by_shape"] = [
        [r["shape"], r["q2"]["bf16_linear_ms"]] for r in w8a8_rows]
    kernels[-1]["tops_bound_share_by_shape"] = [
        [r["shape"], r["q2"]["tops"], r["q2"]["bound_share"]]
        for r in w8a8_rows]
    kernels[-1]["plan_by_shape"] = [[r["shape"], r["q2"]["plan"]]
                                    for r in w8a8_rows]
    kernels[-1]["w8a8_serve"] = {k: w8a8_serve[k] for k in (
        "bundle_bytes_ratio", "cosine_vs_fp_bundle",
        "top1_agree_vs_fp_bundle", "predict_img_per_s")}
    kernels[-1]["families_q2_launches_cosine"] = [
        [r["arch"], r["launches_w8a8"]["w8a8_gemm"], r["cosine"]]
        for r in w8a8_families]
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
    # DETR (ROADMAP A10a) runs the flash pair at Nk != Nq and Swin's B8
    # chain with B6; its numbers in one line beside the kernels'
    _say(json.dumps({"detr": {
        "train_seconds": detr["train"]["seconds"],
        "bbox": detr["train"]["bbox"],
        "loss_total": detr["train"]["train"]["loss_total"],
        "step": {k: detr["step"][k] for k in (
            "step_ms", "host_step_ms", "costs_wait_ms_per_step",
            "matcher_host_ms_per_step", "peak_mem_gb", "loss_total")},
        "device_busy_ms": detr["step"]["profile"]["device_busy_ms"],
        "idle_share": detr["step"]["profile"]["idle_share"],
        "step_vs_fp32": {k: detr["step_vs_plain"][k] for k in (
            "loss_rel_err_kernel_plain", "whole_grad_rel_err_kernel_plain",
            "able_median_max_kernel")},
        "w8a8_cosine": detr["w8a8"]["cosine"]}}))
    # Faster R-CNN / Keypoint R-CNN (ROADMAP A10b): ResNeXt runs no hand
    # kernel, Swin-T its B8 chain and B6, the eval forward under W8A8 Q1/Q2
    _say(json.dumps({"frcnn": {
        "train_seconds": {k: frcnn[k]["seconds"] for k in (
            "train", "swin_train", "kp_train")},
        "epoch_seconds": {k: frcnn[k]["epoch_seconds"] for k in (
            "train", "swin_train", "kp_train")},
        "bbox_ap": {k: frcnn[k]["bbox"]["ap"] for k in (
            "train", "swin_train", "kp_train")},
        "keypoints": frcnn["kp_train"]["keypoints"],
        "step": {k: {m: frcnn[k][m] for m in (
            "step_ms", "host_step_ms", "peak_mem_gb", "loss_total",
            "nms_share_of_step", "syncs_before_loss_read")}
            for k in ("step", "kp_step")},
        "device_busy_ms": {k: frcnn[k]["profile"]["device_busy_ms"]
                           for k in ("step", "kp_step")},
        "idle_share": {k: frcnn[k]["profile"]["idle_share"]
                       for k in ("step", "kp_step")},
        "nms_rpn_decode": [frcnn["step"]["nms_rpn"],
                           frcnn["step"]["nms_decode"]],
        "vs_plain": {k: frcnn["vs_plain"][k] for k in (
            "fpn_rpn_rel_err", "whole_grad_rel_err",
            "median_grad_rel_err")},
        "w8a8": {k: frcnn["w8a8"][k] for k in (
            "launches_w8a8", "cosine", "forward_ms_fp_w8a8")}}}))
    # DETR instance masks and panoptic (ROADMAP A10c): the flash pair, B8,
    # the core and B6 as in DETR; the mask branch runs cuDNN convs and
    # PyTorch's GroupNorm
    st = segm["step"]
    _say(json.dumps({"segm": {
        "train_seconds": {k: segm[k]["seconds"]
                          for k in ("train", "panoptic_train")},
        "bbox_ap_segm_ap_pq": {k: [segm[k]["bbox"]["ap"],
                                   segm[k]["segm"]["ap"],
                                   segm[k]["panoptic"]["pq"]]
                               for k in ("train", "panoptic_train")},
        "panoptic": segm["panoptic_train"]["panoptic"],
        "step": {k: st[k] for k in (
            "step_ms", "host_step_ms", "costs_wait_ms_per_step",
            "matcher_host_ms_per_step", "peak_mem_gb", "loss_total",
            "mask_branch", "mask_branch_share_of_busy", "busy_ms_segm_detr",
            "syncs_per_step", "syncs_per_step_without_mask_losses")},
        "device_busy_ms": st["profile"]["device_busy_ms"],
        "idle_share": st["profile"]["idle_share"],
        "groups_ms": st["profile"]["groups_ms"],
        "vs_fp32": {k: segm["vs_plain"][k] for k in (
            "loss_rel_err_kernel_plain", "pred_masks_rel_err_kernel_plain",
            "grad_rel_err_kernel_plain")},
        "eval_profile_with_without_pq": segm["eval"][
            "profile_with_without_pq"],
        "eval_mask_bytes_per_batch": segm["eval"]["mask_bytes_per_batch"],
        "eval_pixels_differ_kernel_vs_plain": segm["eval"][
            "pixels_differ_kernel_vs_plain"],
        "w8a8": {k: segm["w8a8"][k] for k in (
            "launches_w8a8", "cosine_logits_masks",
            "forward_ms_fp_w8a8")}}}))
    # DETR's device matcher (ROADMAP A10d): numbers at the costs of a real
    # bs8 DETR step, (6, 8, 100, 64), every case beside them; launches from
    # the chunked DETR epoch through cli.coco (one a step)
    auction_rows = detr["auction"]
    head = next(r for r in auction_rows if r["case"] == "detr_step")
    srb = detr["scan_resume_bundle"]
    kernels.append({
        "name": "auction", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/auction.cu",
        "replaces": "vit_torch_tpu/detection/matcher.py:51",
        "launches": srb["launches"]["scan_ckpt"]["auction"],
        # int32 assignments, gated equal to the plain version's
        "max_abs_err": 0.0,
        "ms": head["ms"], "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": None,
        "shape": head["shape"],
        "iters_min_median_max": head["iters_min_median_max"],
        "ms_device_plain_bound_iters_gap_by_case": [
            [r["case"], r["ms"], r["device_ms"], r["plain_ms"],
             r["bound_ms"], r["iters_min_median_max"],
             r["gap_max_over_bound"]] for r in auction_rows],
        "ptxas": auction_ptxas,
        "launches_per_device_step": detr["device_step"]["device"][
            "launches_per_step"]["auction"]})
    # the rest of A10d: the device step beside the host one, the chunked
    # epochs, checkpoints, resume and the served bundles
    dstep = detr["device_step"]
    _say(json.dumps({"a10d": {
        "device_step": {m: {k: dstep[m][k] for k in (
            "step_ms", "host_step_ms", "device_busy_ms", "idle_share",
            "auction_ms", "syncs_before_loss_read")}
            for m in ("device", "host")},
        "device_step_peak_mem_gb_both": dstep["peak_mem_gb_both"],
        "device_step_vs_fp32": {k: detr["device_step_vs_plain"][k] for k in (
            "loss_rel_err_kernel_plain", "whole_grad_rel_err_kernel_plain",
            "able_median_max_kernel")},
        "scan_resume": {k: srb[k] for k in (
            "epoch_seconds", "per_step_epoch_seconds", "reads_per_epoch",
            "ckpt_bytes",
            "ckpt_save_seconds", "ckpt_restore_seconds", "bundle_bytes")},
        "serve": {k: srb["serve"][k] for k in (
            "latency_ms", "dispatches", "unmatched_max_score_box_diff",
            "bundle_vs_predict_max_diff", "w8a8_launches",
            "w8a8_cosine_scores_boxes")},
        "frcnn_scan_bundle": {k: frcnn["scan_bundle"][k] for k in (
            "epoch_seconds", "reads", "latency_ms")}}}))
    with tempfile.TemporaryDirectory() as workdir:
        a8 = parallel_phases(workdir)
    done("parallel")
    _say(json.dumps({"a8": a8}))
    # the parallel modes' per-rank launches and the kernels at their
    # tensor-parallel widths, beside each kernel's full-width row
    par_paths = {"tp_vit": a8["tp_vit"], "pipe_vit": a8["pipe_vit"],
                 "seq_vit": a8["seq_vit"], "tp_swin": a8["tp_swin"]}
    head_rows = {
        "flash_attention_fwd": serving_row, "flash_attention_bwd": train_row,
        "window_block_spatial": block_rows[0]["window_block_spatial"],
        "window_gemm": block_rows[0]["window_gemm"]["products"][0],
        "window_attention": attn_rows[0],
        "window_attention_bwd": attn_bwd_rows[0], "fused_mlp": mlp_rows[0]}
    tp_rows = _tp_width_rows(tp, {
        k: {"shape": r.get("shape", r.get("case", [r.get("T"), r.get("K"),
                                                    r.get("N")])),
            "ms": r.get("ms"), "device_ms": r.get("device_ms")}
        for k, r in head_rows.items()})
    for entry in kernels:
        kernel = entry["name"]
        if kernel in tp_rows:
            entry["tp_widths"] = tp_rows[kernel]
        paths = (("tp_vit", "seq_vit", "pipe_vit")
                 if kernel.startswith("flash") else ("tp_swin",)
                 if kernel.startswith("window") else ())
        for path in paths:    # rank 0's launches over the mode's steps
            entry["launches_by_path"][path] = par_paths[path][
                "launches_by_rank"][0][kernel]
    _say(json.dumps({"phase_seconds": phase_s}))
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": device_name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
