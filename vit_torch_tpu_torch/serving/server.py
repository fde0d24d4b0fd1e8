"""HTTP inference server over classifier and detector bundles,
counterpart of ``vit_torch_tpu/serving/server.py``: the same endpoints,
JSON and request micro-batching, on one CUDA device (or the CPU when
asked).

Endpoints (JSON over HTTP/1.1):

``GET /healthz``
    ``{"status": "ok", "manifest": {...}}``

``GET /stats``
    Request/image/error counts, request latency percentiles over a sliding
    window, and the dispatch batch-size histogram.

``POST /v1/predict`` with body ``{"images": [<base64 image bytes>, ...]}``
    Each entry is a base64-encoded image file (anything PIL decodes).
    Classifier bundles reply ``{"predictions": [{"logits": [...], "label":
    int}, ...]}``; inputs are bicubic-resized host-side to the bundle's
    image size.  Detector bundles letterbox each picture
    (``serving.letterbox_images``) and reply per image ``{"scores",
    "labels", "boxes"}`` (xyxy in the picture's own pixels) above
    ``score_threshold`` (default 0.5) in score order, cut to ``top_k``
    when given, with ``keypoints`` (Keypoint R-CNN) and ``masks_packed``
    (DETRSegm: base64 bit-packed masks at the letterbox's resolution with
    ``shape``, ``dtype`` and ``letterbox_size``).  A ``score_threshold``
    or ``top_k`` that is not a number is a 400.
"""

from __future__ import annotations

import base64
import io
import json
import threading
import time
from collections import Counter, deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FuturesTimeoutError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from vit_torch_tpu_torch.data.datasets import resize_images
from vit_torch_tpu_torch.serving.export import (DETECTION_FORMAT,
                                                letterbox_images, load_bundle)


class MicroBatcher:
    """Coalesce concurrent single-item requests into batched calls.

    ``run_batch(items) -> results`` is invoked on a dedicated worker
    thread with up to ``max_batch`` queued items; arrivals within
    ``max_wait_ms`` of the first queued item ride the same call.
    ``submit`` returns a ``concurrent.futures.Future``.
    """

    def __init__(self, run_batch: Callable[[List], List],
                 max_batch: int = 32, max_wait_ms: float = 5.0):
        self._run = run_batch
        self.max_batch = int(max_batch)
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_wait = max(0.0, float(max_wait_ms) / 1000.0)
        self._lock = threading.Condition()
        self._queue: List = []            # (item, Future)
        self._closed = False
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher closed")
            self._queue.append((item, fut))
            self._lock.notify()
        return fut

    def close(self) -> None:
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._worker.join(timeout=5)

    def _loop(self) -> None:
        while True:
            with self._lock:
                while not self._queue and not self._closed:
                    self._lock.wait()
                if self._closed and not self._queue:
                    return
                deadline = time.monotonic() + self.max_wait
                while (len(self._queue) < self.max_batch
                       and not self._closed):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._lock.wait(timeout=remaining)
                batch = self._queue[:self.max_batch]
                del self._queue[:self.max_batch]
            items = [it for it, _ in batch]
            try:
                results = self._run(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(items)} items")
                for (_, fut), res in zip(batch, results):
                    if not fut.cancelled():   # a caller-cancelled future
                        fut.set_result(res)   # must not poison the batch
            except BaseException as e:  # propagate to every waiter
                for _, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)


class ServingStats:
    """Thread-safe sliding-window serving telemetry."""

    def __init__(self, window: int = 1024):
        self._lock = threading.Lock()
        self._latencies = deque(maxlen=window)   # seconds, per request
        self._batch_sizes = Counter()            # dispatch size -> count
        self.requests = 0
        self.images = 0
        self.errors = 0

    def record_request(self, n_images: int, seconds: float) -> None:
        with self._lock:
            self.requests += 1
            self.images += n_images
            self._latencies.append(seconds)

    def record_dispatch(self, batch_size: int) -> None:
        with self._lock:
            self._batch_sizes[batch_size] += 1

    def record_error(self) -> None:
        with self._lock:
            self.errors += 1

    def snapshot(self) -> Dict:
        with self._lock:
            lat = sorted(self._latencies)
            sizes = dict(sorted(self._batch_sizes.items()))
            out = {"requests": self.requests, "images": self.images,
                   "errors": self.errors,
                   "dispatches": {str(k): v for k, v in sizes.items()}}
        if lat:
            def pct(p):
                return round(1000 * lat[min(len(lat) - 1,
                                            int(p * len(lat)))], 3)
            out["latency_ms"] = {"p50": pct(0.50), "p90": pct(0.90),
                                 "p99": pct(0.99),
                                 "window": len(lat)}
        return out


def _decode_image(b64: str) -> np.ndarray:
    from PIL import Image
    # lenient decode: standard encoders wrap lines with \n
    raw = base64.b64decode(b64)
    img = Image.open(io.BytesIO(raw)).convert("RGB")
    return np.asarray(img, np.uint8)


class BundleServer:
    """Serve one classifier or detector bundle over HTTP with
    micro-batching, on ``device`` (CUDA when omitted; raises where there
    is none)."""

    def __init__(self, bundle_dir: str, host: str = "127.0.0.1",
                 port: int = 8000, max_batch: Optional[int] = None,
                 max_wait_ms: float = 5.0,
                 predict_timeout_s: float = 120.0,
                 device: Optional[Union[str, torch.device]] = None):
        self.model = load_bundle(bundle_dir, device=device)
        self.manifest: Dict = self.model.manifest
        self.is_detection = self.manifest["format"] == DETECTION_FORMAT
        self.image_size = int(self.manifest["image_size"])
        if max_batch is None:
            max_batch = max(self.model.batch_sizes)
        # bound on Future.result(): a wedged device dispatch turns into
        # 504s, not a pile of blocked handler threads
        self.predict_timeout_s = float(predict_timeout_s)
        self.stats = ServingStats()
        self._batcher = MicroBatcher(self._run_batch, max_batch=max_batch,
                                     max_wait_ms=max_wait_ms)
        handler = _make_handler(self)
        self._httpd = ThreadingHTTPServer((host, port), handler)
        self._thread: Optional[threading.Thread] = None
        self._serving = False

    @property
    def address(self):
        """(host, port) actually bound — port 0 resolves here."""
        return self._httpd.server_address[:2]

    def _run_batch(self, images: Sequence[np.ndarray]) -> List[Dict]:
        self.stats.record_dispatch(len(images))
        if self.is_detection:
            out = self.model.predict_tree(
                letterbox_images(list(images), self.image_size))
            return [{k: v[i] for k, v in out.items()}
                    for i in range(len(images))]
        S = self.image_size
        stacked = np.stack([resize_images(img[None], S)[0]
                            for img in images])
        logits = self.model.predict(stacked)
        return [{"logits": np.asarray(row)} for row in logits]

    def serve_forever(self) -> None:
        self._serving = True
        self._httpd.serve_forever()

    def start(self) -> None:
        """Run the server on a background thread (tests, notebooks)."""
        self._serving = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)
        self._thread.start()

    def shutdown(self) -> None:
        if self._serving:
            # socketserver.shutdown() blocks on serve_forever's exit
            # event, which never fires if serving never started
            self._httpd.shutdown()
        self._httpd.server_close()
        self._batcher.close()
        if self._thread is not None:
            self._thread.join(timeout=5)


def _format_prediction(server: BundleServer, raw: Dict, thr: float,
                       top_k: Optional[int]) -> Dict:
    """One image's reply: a classifier's logits and label, or a
    detector's detections above ``thr`` in score order (``top_k`` of
    them when given), with keypoints and base64 packed masks."""
    if not server.is_detection:
        logits = raw["logits"]
        return {"logits": [float(v) for v in logits],
                "label": int(np.argmax(logits))}
    scores = raw["scores"]
    order = np.argsort(-scores)
    keep = order[scores[order] >= thr]
    if top_k is not None:
        keep = keep[:top_k]
    out = {"scores": [float(s) for s in scores[keep]],
           "labels": [int(l) for l in raw["labels"][keep]],
           "boxes": [[float(c) for c in b] for b in raw["boxes"][keep]]}
    if "keypoints" in raw:           # (D, K, 3): x, y, score
        out["keypoints"] = raw["keypoints"][keep].tolist()
    if "masks_packed" in raw:
        # (Q, S, ceil(S / 8)) uint8 at the letterbox's resolution; clients
        # unpack with np.unpackbits along the last axis
        kept = np.ascontiguousarray(raw["masks_packed"][keep])
        out["masks_packed"] = {
            "b64": base64.b64encode(kept.tobytes()).decode(),
            "shape": list(kept.shape), "dtype": "uint8",
            "letterbox_size": server.image_size}
    return out


def _make_handler(server: BundleServer):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):   # quiet by default
            pass

        def _reply(self, code: int, payload: Dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._reply(200, {"status": "ok",
                                  "manifest": server.manifest})
            elif self.path == "/stats":
                self._reply(200, server.stats.snapshot())
            else:
                self._reply(404, {"error": f"unknown path {self.path}"})

        def do_POST(self):
            if self.path != "/v1/predict":
                self._reply(404, {"error": f"unknown path {self.path}"})
                return
            t0 = time.monotonic()
            try:
                n = int(self.headers.get("Content-Length", 0))
                req = json.loads(self.rfile.read(n) or b"{}")
                b64s = req["images"]
                if not isinstance(b64s, list) or not b64s:
                    raise ValueError("'images' must be a non-empty list")
                # request-field validation belongs with the 400s: a bad
                # score_threshold is a client error
                thr = float(req.get("score_threshold", 0.5))
                top_k = req.get("top_k")
                top_k = None if top_k is None else int(top_k)
                images = [_decode_image(b) for b in b64s]
            except Exception as e:
                server.stats.record_error()
                self._reply(400, {"error": f"bad request: {e}"})
                return
            try:
                futs = [server._batcher.submit(img) for img in images]
                preds = [_format_prediction(
                    server, f.result(timeout=server.predict_timeout_s),
                    thr, top_k) for f in futs]
            except FuturesTimeoutError:
                server.stats.record_error()
                self._reply(504, {"error": "inference timed out after "
                                  f"{server.predict_timeout_s}s"})
                return
            except Exception as e:
                server.stats.record_error()
                self._reply(500, {"error": f"inference failed: {e}"})
                return
            server.stats.record_request(len(images), time.monotonic() - t0)
            self._reply(200, {"predictions": preds})

    return Handler
