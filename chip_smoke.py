"""Drive the PyTorch/CUDA port on one GPU, end to end.

    python3 chip_smoke.py

1. prints the device and its power limit;
2. builds every CUDA kernel of the serving path from the sources in the
   checkout (``nvcc``, ``sm_90a``);
3. holds each kernel against its plain PyTorch version on the card at the
   shapes the serving path gives it, and times kernel, plain version and
   the PyTorch library call that computes the same function;
4. exports a full-width dino_vitb8 @224 classifier with seeded weights
   through ``vit_torch_tpu_torch.cli.export``, serves it with
   ``BundleServer`` on the card, sends concurrent HTTP requests, checks the
   replies, checks the logits against the same weights run through the
   plain attention, and checks that every attention went through the
   kernel (launch count = layers x dispatches);
5. prints one JSON line with each kernel's numbers, then the card's name
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
H100_BF16_FLOPS = 989e12          # dense tensor-core peak, SXM
H100_BYTES_PER_S = 3.35e12
ARCH, IMAGE_SIZE, CLASSIFIER, BUCKETS = "dino_vitb8", 224, "512,10", "1,8,32"
ATTN_SHAPES = [(32, 12, 785, 64), (8, 12, 197, 64), (2, 2, 65, 32),
               (1, 1, 1, 64)]


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
    if any(t in low for t in ("gemm", "xmma", "cutlass", "cublas", "nvjet")):
        return "matmul"
    if "layer_norm" in low:
        return "layer_norm"
    if "copy" in low:
        return "copy_cast"          # dtype casts, H2D/D2H
    return "other"


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
    groups, top = {}, []
    for ev in prof.key_averages():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3 / iters
        group = _kernel_group(ev.key)
        groups[group] = groups.get(group, 0.0) + ms
        top.append((ms, ev.count // iters, ev.key[:90]))
    busy = sum(groups.values())
    top.sort(reverse=True)
    return {"bucket": len(batch), "window_ms": window_ms,
            "device_busy_ms": busy,
            "idle_share": 1 - busy / window_ms if busy else None,
            "groups_ms": groups, "top_kernels_ms_calls": top[:8]}


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

        def plain(q, k, v, *, scale):
            return fa.flash_attention_bhnd_reference(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                scale=scale).transpose(1, 2)

        with mock.patch.object(attention_mod, "flash_attention", plain):
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

    rows = [check_flash_kernel(shape, seed=i)
            for i, shape in enumerate(ATTN_SHAPES)]
    serving_row = rows[0]

    with tempfile.TemporaryDirectory() as workdir:
        launches = serve_end_to_end(workdir)

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
        "shape": serving_row["shape"]}]
    _say(json.dumps({"kernels": kernels}))
    _say(smi)
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
