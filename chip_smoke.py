"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the device and its power limit;
2. builds every CUDA kernel (``_build.KERNELS``: the flash-attention
   forward and backward, the Swin window-attention core forward and
   backward and the window GEMM) from the sources in the checkout
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
   shapes;
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
8. prints one JSON line with each kernel's numbers, then the card's name
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
        return "window_gemm"        # the B8 / B9 products
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
                     logits_tol: float, relative: bool):
    """Export → BundleServer on cuda → concurrent HTTP requests; prints
    the serving numbers and returns the launch counts of the HTTP run.
    Each of ``kernels`` must launch once per layer per dispatch, and no
    other kernel at all.  ``plain()`` is a context that patches the plain
    versions in; the logits of the two must agree within ``logits_tol``
    (relative to max |plain logit| when ``relative``)."""
    import torch
    from vit_torch_tpu_torch.cli import export as cli_export
    from vit_torch_tpu_torch.data.datasets import resize_images
    from vit_torch_tpu_torch.serving.server import BundleServer

    bundle = f"{workdir}/bundle-{arch}"
    t0 = time.perf_counter()
    cli_export.main(["--arch", arch, "--classifier", CLASSIFIER,
                     "--image_size", str(image_size), "--bs", BUCKETS,
                     "--dataset", "stl10", "--out", bundle])
    _say(f"export {arch} seconds {time.perf_counter() - t0:.2f}")

    server = BundleServer(bundle, port=0, max_wait_ms=10)
    try:
        depth = _depth(server.model.model.backbone)
        addr = server.address
        server.start()
        rng = np.random.default_rng(0)
        batch32 = rng.integers(0, 256, (32, image_size, image_size, 3),
                               dtype=np.uint8)
        for bs in (1, 8, 32):                   # warm cuBLAS per bucket
            server.model.predict(batch32[:bs])

        sizes = (96, 160, 224, 256, 300, 517)
        singles = [rng.integers(0, 256, (s, s + 13 * (i % 3), 3),
                                dtype=np.uint8)
                   for i, s in enumerate(sizes * 4)]
        payloads = ([{"images": [_png_b64(img)]} for img in singles]
                    + [{"images": [_png_b64(img) for img in batch32]}])
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
             f"{len(singles) + len(batch32)} seconds {http_s:.3f} "
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
        http32 = np.asarray([p["logits"] for p in replies[-1][1]["predictions"]])

        # logits: kernel path vs plain versions, same weights, on the card
        resized = resize_images(batch32, image_size)
        kernel_logits = server.model.predict(resized)
        with plain():
            plain_logits = server.model.predict(resized)
        err = float(np.abs(kernel_logits - plain_logits).max())
        err_http = float(np.abs(http32 - plain_logits).max())
        max_logit = float(np.abs(plain_logits).max())
        _say(f"logits {arch} kernel vs plain: max abs err {err:.5f} "
             f"(http {err_http:.5f}), max |logit| {max_logit:.4f}, argmax "
             f"agree "
             f"{int((kernel_logits.argmax(1) == plain_logits.argmax(1)).sum())}"
             f"/32")
        limit = logits_tol * (max_logit if relative else 1.0)
        if not max(err, err_http) <= limit:
            raise AssertionError(f"served logits differ from the plain "
                                 f"versions by {max(err, err_http)} > "
                                 f"{limit}")

        # predict time per bucket, uint8 in, logits out, host clock; the
        # 32 bucket gives the served img/s
        predict_ms = {}
        for bs in (1, 8, 32):
            t0 = time.perf_counter()
            for _ in range(20):
                server.model.predict(batch32[:bs])
            predict_ms[bs] = 1e3 * (time.perf_counter() - t0) / 20
        x = torch.from_numpy(batch32).to(server.model.device)
        with torch.inference_mode():
            fwd_ms = _time_ms(lambda: server.model.model(
                (x.to(server.model.mean.dtype) / 255.0 - server.model.mean)
                / server.model.std), iters=10)
        _say(json.dumps({
            "serve": {"arch": arch, "image_size": image_size, "depth": depth,
                      "bucket": 32,
                      "predict_img_per_s": 32e3 / predict_ms[32],
                      "predict_ms_by_bucket": predict_ms,
                      "forward_ms_cuda_events": fwd_ms,
                      "forward_img_per_s": 32e3 / fwd_ms,
                      "forward_tflop_per_s": 32 * flops_per_image / fwd_ms
                      / 1e9,
                      "stats": stats, "logits_max_abs_err": err,
                      "max_abs_logit": max_logit}}))
        _say(json.dumps({"profile": profile_predict(server.model, batch32)}))
        return launches
    finally:
        server.shutdown()


def _plain_attention():
    from vit_torch_tpu_torch.ops import attention as attention_mod
    return mock.patch.object(attention_mod, "flash_attention_qkv", _plain_qkv)


def _counters():
    """Every kernel wrapper, by the name it has in the kernels line."""
    from vit_torch_tpu_torch.ops import flash_attention as fa
    from vit_torch_tpu_torch.ops import window_attention as wa
    from vit_torch_tpu_torch.ops import window_block as wb
    return {"flash_attention_fwd": fa.flash_attention_bhnd,
            "flash_attention_bwd": fa.flash_attention_bwd,
            "window_attention": wa.window_attention,
            "window_attention_bwd": wa.window_attention_bwd,
            "window_block_spatial": wb.window_block_spatial,
            "window_block_full_spatial": wb.window_block_full_spatial}


def _reset_counts():
    for fn in _counters().values():
        fn.launches = 0


def _read_counts():
    return {name: fn.launches for name, fn in _counters().items()}


def _want(**launches):
    """Launch counts with every kernel not named at 0."""
    return {name: launches.get(name, 0) for name in _counters()}


def _run_cli(main_fn, argv, fp: str, mode: str, want):
    """One epoch of the synthetic data through a port CLI on the card;
    checks the stats JSON and the kernels' launch counts."""
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
        if r[0]["sample"] != SYNTHETIC_N:
            raise AssertionError(f"{mode}: {split} saw {r[0]['sample']} "
                                 f"samples, not {SYNTHETIC_N}")
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


def steady_state_train(iters: int = 12):
    """The finetune step at bs32 (augment, forward, loss, backward, AdamW)
    on the card: CUDA-event time over ``iters`` steps after warm-up, MFU
    against the dense bf16 peak, a profile, and the launches per step."""
    import torch
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    zm, trainer, batch = _train_setup(TRAIN_BS)
    zm.model.train()
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
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    step_ms = start.elapsed_time(end) / iters
    step_flops = 3 * vit_flops(VIT_CONFIGS[ARCH], IMAGE_SIZE) * TRAIN_BS
    row = {"arch": ARCH, "image_size": IMAGE_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "train_step_ms": step_ms,
           "host_step_ms": host_ms,
           "train_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": profile_train_step(trainer, batch)}
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
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    step_ms = start.elapsed_time(end) / iters
    fwd_flops = swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile = profile_train_step(trainer, batch)
    zm.model.eval()
    x = trainer.eval_transform(batch[0])
    _reset_counts()
    with torch.no_grad():
        eval_ms = _time_ms(lambda: zm.model(x), iters=10)
    eval_counts = _read_counts()
    row = {"arch": SWIN_ARCH, "image_size": SWIN_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "lineareval_step_ms": step_ms,
           "host_step_ms": host_ms,
           "lineareval_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": fwd_flops / 1e12,
           "mfu": fwd_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step, "peak_mem_gb": peak_gb,
           "eval_forward_ms": eval_ms,
           "eval_forward_img_per_s": TRAIN_BS * 1e3 / eval_ms,
           "eval_forward_mfu": fwd_flops / (eval_ms / 1e3) / H100_BF16_FLOPS,
           "profile": profile}
    _say(json.dumps({"swin_lineareval_step": row}))
    if per_step != _want(window_attention=SWIN_DEPTH,
                         window_block_spatial=SWIN_DEPTH - 1,
                         window_block_full_spatial=1):
        raise AssertionError(f"launches per lineareval step {per_step}")
    if eval_counts != _want(window_attention=SWIN_DEPTH * 12,
                            window_block_full_spatial=SWIN_DEPTH * 12):
        raise AssertionError(f"launches in 12 eval forwards {eval_counts}")
    return row


def compare_step_with_plain(bs: int = 8):
    """Loss and gradients of one bs8 finetune step (dropout-free model,
    eval-normalised batch, no optimizer step) on the kernel path and on
    the plain attention, same weights and batch."""
    import torch
    from vit_torch_tpu_torch.ops import attention as attention_mod
    from vit_torch_tpu_torch.train.steps import cross_entropy_loss
    zm, trainer, (images, labels, mask) = _train_setup(bs, seed=1)
    model = zm.model
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
    with mock.patch.object(attention_mod, "flash_attention_qkv",
                           _plain_qkv):
        loss_p, grads_p = loss_and_grads()
    if _read_counts() != counts:
        raise AssertionError("the plain step launched a kernel")
    rel = {n: ((grads_k[n] - g).norm() / g.norm().clamp_min(1e-30)).item()
           for n, g in grads_p.items()}
    worst = max(rel, key=rel.get)
    row = {"bs": bs, "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_abs_diff": abs(loss_k - loss_p),
           "max_grad_rel_err": rel[worst], "worst_param": worst,
           "median_grad_rel_err": float(np.median(list(rel.values()))),
           "launches": counts}
    _say(json.dumps({"step_vs_plain": row}))
    if not (np.isfinite(loss_k) and row["loss_abs_diff"] <= STEP_LOSS_ATOL
            and rel[worst] <= STEP_GRAD_RTOL):
        raise AssertionError(f"kernel step vs plain step: {row} (limits "
                             f"loss {STEP_LOSS_ATOL}, grad {STEP_GRAD_RTOL})")
    return row


def steady_state_swin_finetune(iters: int = 12):
    """The swin_base_384 fine-tune step at bs32 (augment, forward with
    grad, loss, backward through B6, AdamW on every parameter) on the
    card: CUDA-event time over ``iters`` steps after warm-up, MFU with
    step FLOPs = 3 x forward (``bench.py``'s count), a profile by kernel
    group with the idle share, the launches per step and the peak memory
    allocated."""
    import torch
    from vit_torch_tpu_torch.models.swin import SWIN_CONFIGS, swin_flops
    zm, trainer, batch = _train_setup(TRAIN_BS, arch=SWIN_ARCH,
                                      image_size=SWIN_SIZE, lr=1e-4)
    zm.model.train()
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
    host_ms = 1e3 * (time.perf_counter() - t0) / iters
    step_ms = start.elapsed_time(end) / iters
    step_flops = 3 * swin_flops(SWIN_CONFIGS[SWIN_ARCH], SWIN_SIZE) * TRAIN_BS
    row = {"arch": SWIN_ARCH, "image_size": SWIN_SIZE, "bs": TRAIN_BS,
           "opt": "adamw", "iters": iters, "finetune_step_ms": step_ms,
           "host_step_ms": host_ms,
           "finetune_img_per_s": TRAIN_BS * 1e3 / step_ms,
           "step_tflop": step_flops / 1e12,
           "mfu": step_flops / (step_ms / 1e3) / H100_BF16_FLOPS,
           "launches_per_step": per_step,
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
           "profile": profile_train_step(trainer, batch)}
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
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
