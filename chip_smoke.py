"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the device and its power limit;
2. builds every CUDA kernel (``_build.KERNELS``: the flash-attention
   forward and backward) from the sources in the checkout (``nvcc``,
   ``sm_90a``);
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving and training paths give it, and times kernel, plain
   version and the PyTorch library call that computes the same function;
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
7. prints one JSON line with each kernel's numbers, then the card's name
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


def _attention_bound_ms(B, H, N, D):
    flops = 4 * B * H * N * N * D            # QK^T and PV, 2 flops per MAC
    nbytes = 4 * B * H * N * D * 2           # q, k, v read once, o written
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def _bwd_bound_ms(B, H, N, D):
    flops = 10 * B * H * N * N * D           # S, dP, dV, dQ, dK products
    nbytes = 8 * B * H * N * D * 2 + B * H * N * 4   # + the fp32 LSE
    t_ops, t_bytes = flops / H100_BF16_FLOPS, nbytes / H100_BYTES_PER_S
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


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


def serve_end_to_end(workdir: str):
    """Export → BundleServer on cuda → concurrent HTTP requests; prints
    the serving numbers and returns the flash launches of the HTTP run."""
    import torch
    from vit_torch_tpu_torch.cli import export as cli_export
    from vit_torch_tpu_torch.data.datasets import resize_images
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS, vit_flops
    from vit_torch_tpu_torch.ops import attention as attention_mod
    from vit_torch_tpu_torch.ops import flash_attention as fa
    from vit_torch_tpu_torch.serving.server import BundleServer

    bundle = f"{workdir}/bundle"
    t0 = time.perf_counter()
    cli_export.main(["--arch", ARCH, "--classifier", CLASSIFIER,
                     "--image_size", str(IMAGE_SIZE), "--bs", BUCKETS,
                     "--dataset", "stl10", "--out", bundle])
    _say(f"export seconds {time.perf_counter() - t0:.2f}")

    server = BundleServer(bundle, port=0, max_wait_ms=10)
    try:
        depth = len(server.model.model.backbone.blocks)
        addr = server.address
        server.start()
        rng = np.random.default_rng(0)
        batch32 = rng.integers(0, 256, (32, IMAGE_SIZE, IMAGE_SIZE, 3),
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
        fa.flash_attention_bhnd.launches = 0
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        http_s = time.perf_counter() - t0
        launches = fa.flash_attention_bhnd.launches
        if any(t.is_alive() for t in threads):
            raise AssertionError("an HTTP request did not finish")
        status, stats = _get(addr, "/stats")
        if status != 200:
            raise AssertionError(f"/stats answered {status}")
        dispatches = sum(stats["dispatches"].values())
        _say(f"http requests {len(payloads)} images "
             f"{len(singles) + len(batch32)} seconds {http_s:.3f} "
             f"dispatches {stats['dispatches']} flash launches {launches}")
        if launches != depth * dispatches or dispatches == 0:
            raise AssertionError(f"flash launches {launches} != {depth} x "
                                 f"{dispatches} dispatches")
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

        # logits: kernel path vs plain attention, same weights, on the card
        resized = resize_images(batch32, IMAGE_SIZE)
        kernel_logits = server.model.predict(resized)

        with mock.patch.object(attention_mod, "flash_attention_qkv",
                               _plain_qkv):
            plain_logits = server.model.predict(resized)
        err = float(np.abs(kernel_logits - plain_logits).max())
        err_http = float(np.abs(http32 - plain_logits).max())
        _say(f"logits kernel vs plain attention: max abs err {err:.5f} "
             f"(http {err_http:.5f}), max |logit| "
             f"{float(np.abs(plain_logits).max()):.4f}, argmax agree "
             f"{int((kernel_logits.argmax(1) == plain_logits.argmax(1)).sum())}"
             f"/32")
        if not max(err, err_http) <= LOGITS_ATOL:
            raise AssertionError(f"served logits differ from the plain "
                                 f"attention by {max(err, err_http)}")

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
            "serve": {"arch": ARCH, "image_size": IMAGE_SIZE, "depth": depth,
                      "bucket": 32,
                      "predict_img_per_s": 32e3 / predict_ms[32],
                      "predict_ms_by_bucket": predict_ms,
                      "forward_ms_cuda_events": fwd_ms,
                      "forward_img_per_s": 32e3 / fwd_ms,
                      "forward_tflop_per_s": 32 * vit_flops(
                          VIT_CONFIGS[ARCH], IMAGE_SIZE) / fwd_ms / 1e9,
                      "stats": stats, "logits_max_abs_err": err}}))
        _say(json.dumps({"profile": profile_predict(server.model, batch32)}))
        return launches
    finally:
        server.shutdown()


def _reset_counts():
    from vit_torch_tpu_torch.ops import flash_attention as fa
    fa.flash_attention_bhnd.launches = 0
    fa.flash_attention_bwd.launches = 0


def _read_counts():
    from vit_torch_tpu_torch.ops import flash_attention as fa
    return {"flash_attention_fwd": fa.flash_attention_bhnd.launches,
            "flash_attention_bwd": fa.flash_attention_bwd.launches}


def train_through_cli(workdir: str, lineareval: bool):
    """One epoch of the synthetic data through the port's CLI on the card;
    checks the stats JSON and the kernels' launch counts."""
    from vit_torch_tpu_torch.cli import main as cli_main
    from vit_torch_tpu_torch.models.vit import VIT_CONFIGS
    mode = "lineareval" if lineareval else "finetune"
    fp = f"{workdir}/{mode}.json"
    argv = TRAIN_ARGS + ["--stats_fp", fp] + (
        ["--lineareval", "--cache_features"] if lineareval else [])
    _reset_counts()
    t0 = time.perf_counter()
    cli_main.main(argv)
    seconds = time.perf_counter() - t0
    counts = _read_counts()
    depth = VIT_CONFIGS[ARCH].depth
    steps = SYNTHETIC_N // TRAIN_BS           # per split
    if lineareval:
        # the frozen backbone runs once over each split (forward only);
        # the head trains on cached features
        want = {"flash_attention_fwd": depth * 2 * steps,
                "flash_attention_bwd": 0}
    else:
        want = {"flash_attention_fwd": depth * 2 * steps,
                "flash_attention_bwd": depth * steps}
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


def _train_setup(bs: int, seed: int = 0):
    """A seeded full-width finetune trainer and one uint8 batch on the
    card."""
    import torch
    from vit_torch_tpu_torch.data.augment import (make_eval_transform,
                                                  make_train_augment)
    from vit_torch_tpu_torch.data.datasets import (NORM_VALUES,
                                                   _synthetic_arrays)
    from vit_torch_tpu_torch.models.zoo import VisionModelZoo
    from vit_torch_tpu_torch.train.trainer import Trainer
    zm = VisionModelZoo.get_model(
        ARCH, classifier=[512, 10], image_size=IMAGE_SIZE,
        generator=torch.Generator().manual_seed(seed))
    norm = NORM_VALUES["synthetic"]
    trainer = Trainer(zm, opt="adamw", lr=1e-4, seed=seed,
                      augment_fn=make_train_augment(**norm,
                                                    dtype=torch.bfloat16),
                      eval_transform=make_eval_transform(
                          **norm, dtype=torch.bfloat16),
                      print_progress=False)
    imgs, labels = _synthetic_arrays("train", n=bs, image_size=IMAGE_SIZE,
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
    if per_step != {"flash_attention_fwd": depth,
                    "flash_attention_bwd": depth}:
        raise AssertionError(f"launches per train step {per_step}")
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

    with tempfile.TemporaryDirectory() as workdir:
        launches = serve_end_to_end(workdir)
        finetune = train_through_cli(workdir, lineareval=False)
        lineareval = train_through_cli(workdir, lineareval=True)
    steady_state_train()
    compare_step_with_plain()

    kernels = [{
        "name": "flash_attention_fwd", "route": "cuda",
        "source": "vit_torch_tpu_torch/csrc/flash_attention_fwd.cu",
        "replaces": "vit_torch_tpu/ops/flash_attention.py:251",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": serving_row["ms"], "plain_ms": serving_row["plain_ms"],
        "bound_ms": serving_row["bound_ms"],
        "bound_by": serving_row["bound_by"],
        "library_ms": serving_row["library_ms"],
        "shape": serving_row["shape"],
        "launches_by_path": {
            "serve": launches,
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
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
