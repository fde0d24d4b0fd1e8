"""Port serving: a JAX bundle and a port bundle of the same weights give the
same logits; the port's bucketing, HTTP server and CLIs keep the JAX
package's contract; and nothing runs on the CPU unless it is asked for."""

import base64
import http.client
import io
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from vit_torch_tpu.data.datasets import NORM_VALUES as JAX_NORM_VALUES
from vit_torch_tpu.models import VisionModelZoo as JaxZoo
from vit_torch_tpu.serving import export_classifier as jax_export_classifier
from vit_torch_tpu.serving import load_bundle as jax_load_bundle
from vit_torch_tpu.serving import save_bundle as jax_save_bundle
from vit_torch_tpu_torch.checkpoint.jax_import import state_dict_from_jax
from vit_torch_tpu_torch.cli import export as cli_export
from vit_torch_tpu_torch.cli import serve as cli_serve
from vit_torch_tpu_torch.data.datasets import NORM_VALUES
from vit_torch_tpu_torch.models.zoo import VisionModelZoo
from vit_torch_tpu_torch.serving import (
    BundleServer, export_classifier, load_bundle, save_bundle)

NORM = NORM_VALUES["stl10"]


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """A JAX bundle and a port bundle of one set of fp32 weights."""
    jzm = JaxZoo.get_model("vit_tiny_test", classifier=[12, 10],
                           image_size=32, dtype=jnp.float32)
    variables = jzm.init(jax.random.PRNGKey(0), image_size=32)
    jdir = str(tmp_path_factory.mktemp("jax_bundle"))
    jax_save_bundle(jdir, jax_export_classifier(
        jzm, variables, image_size=32, batch_sizes=[2, 4],
        norm=JAX_NORM_VALUES["stl10"]))
    zm = VisionModelZoo.get_model("vit_tiny_test", classifier=[12, 10],
                                  image_size=32, dtype=torch.float32,
                                  device="cpu")
    zm.model.load_state_dict(state_dict_from_jax(
        jax.tree.map(np.asarray, variables["params"])))
    tdir = str(tmp_path_factory.mktemp("port_bundle"))
    save_bundle(tdir, export_classifier(zm, batch_sizes=[2, 4], norm=NORM))
    return jdir, tdir


def test_port_bundle_matches_jax_bundle(bundles):
    jdir, tdir = bundles
    assert NORM == JAX_NORM_VALUES["stl10"]
    images = np.random.default_rng(0).integers(0, 256, (4, 32, 32, 3),
                                               dtype=np.uint8)
    ref = jax_load_bundle(jdir).predict(images)
    model = load_bundle(tdir, device="cpu")
    got = model.predict(images)
    assert got.dtype == np.float32 and got.shape == (4, 10)
    np.testing.assert_allclose(got, ref, atol=1e-4, rtol=0)
    jm, tm = (json.load(open(os.path.join(d, "manifest.json")))
              for d in (jdir, tdir))
    for key in ("arch", "family", "image_size", "batch_sizes", "num_classes",
                "norm", "activation_dtype", "param_dtype", "num_devices",
                "w8a8"):
        assert tm[key] == jm[key], key
    assert tm["format"] == "vit_torch_tpu_torch.serving/1"


def test_predict_pads_and_chunks(bundles):
    """7 images run as a chunk of 4 plus 3 padded to 4; each row equals the
    image run alone (padded to 2)."""
    model = load_bundle(bundles[1], device="cpu")
    images = np.random.default_rng(1).integers(0, 256, (7, 32, 32, 3),
                                               dtype=np.uint8)
    got = model.predict(images)
    assert got.shape == (7, 10)
    alone = np.concatenate([model.predict(images[i:i + 1]) for i in range(7)])
    np.testing.assert_allclose(got, alone, atol=1e-5, rtol=0)
    with pytest.raises(ValueError):
        model.predict(images[0])                      # not NHWC
    with pytest.raises(ValueError, match="uint8"):
        model.predict(images.astype(np.float32))
    with pytest.raises(ValueError, match="exported for 32x32"):
        model.predict(np.zeros((2, 48, 48, 3), np.uint8))


def _png_b64(arr):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return base64.b64encode(buf.getvalue()).decode()


def _request(addr, method, path, body=None):
    conn = http.client.HTTPConnection(*addr, timeout=30)
    try:
        conn.request(method, path, body=None if body is None
                     else json.dumps(body))
        resp = conn.getresponse()
        return resp.status, json.loads(resp.read())
    finally:
        conn.close()


def test_server_endpoints_on_cpu(bundles):
    server = BundleServer(bundles[1], port=0, max_wait_ms=50, device="cpu")
    server.start()
    try:
        addr = server.address
        status, health = _request(addr, "GET", "/healthz")
        assert status == 200 and health["status"] == "ok"
        assert health["manifest"]["arch"] == "vit_tiny_test"
        rng = np.random.default_rng(2)
        images = [rng.integers(0, 256, (s, s, 3), dtype=np.uint8)
                  for s in (32, 20, 45)]               # resize runs
        results = [None] * len(images)

        def one(i):
            results[i] = _request(addr, "POST", "/v1/predict",
                                  {"images": [_png_b64(images[i])]})

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(images))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive()
        for status, body in results:
            assert status == 200
            (pred,) = body["predictions"]
            assert len(pred["logits"]) == 10
            assert pred["label"] == int(np.argmax(pred["logits"]))
        status, body = _request(addr, "POST", "/v1/predict", {"images": []})
        assert status == 400
        status, stats = _request(addr, "GET", "/stats")
        assert status == 200
        assert stats["requests"] == 3 and stats["images"] == 3
        assert stats["errors"] == 1
        assert sum(int(k) * v for k, v in stats["dispatches"].items()) == 3
        assert _request(addr, "GET", "/nope")[0] == 404
    finally:
        server.shutdown()


def test_cli_export_then_load(tmp_path):
    """cli.export on the CPU, with --torch_ckpt holding a DINO-style
    checkpoint trained at another grid (32 px) than the export's (48 px)."""
    src = VisionModelZoo.get_model("vit_tiny_test", image_size=32,
                                   device="cpu")
    ckpt = tmp_path / "dino.pth"
    torch.save({"teacher": {f"module.backbone.{k}": v for k, v in
                            src.model.backbone.state_dict().items()}}, ckpt)
    out = tmp_path / "bundle"
    cli_export.main(["--arch", "vit_tiny_test", "--classifier", "8,3",
                     "--image_size", "48", "--bs", "1,2", "--dataset",
                     "stl10", "--torch_ckpt", str(ckpt), "--device", "cpu",
                     "--out", str(out)])
    model = load_bundle(str(out), device="cpu")
    assert model.manifest["classifier"] == [8, 3]
    assert model.manifest["batch_sizes"] == [1, 2]
    sd = model.model.backbone.state_dict()
    np.testing.assert_array_equal(
        sd["blocks.1.attn.qkv.weight"].numpy(),
        src.model.backbone.state_dict()["blocks.1.attn.qkv.weight"].numpy())
    assert sd["pos_embed"].shape == (1, 1 + 36, 64)
    logits = model.predict(np.zeros((3, 48, 48, 3), np.uint8))
    assert logits.shape == (3, 3) and np.isfinite(logits).all()


@pytest.mark.parametrize("flag", [["--platforms", "cpu,cuda"],
                                  ["--num_devices", "2"], ["--w8a8"]])
def test_cli_export_refuses_later_slices(flag, tmp_path):
    with pytest.raises(NotImplementedError):
        cli_export.main(["--arch", "vit_tiny_test", "--device", "cpu",
                         "--out", str(tmp_path), *flag])


def test_no_silent_cpu_fallback(bundles, tmp_path):
    """Without device='cpu' the entry points ask for CUDA, and raise on a
    machine that has none."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BundleServer(bundles[1], port=0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_serve.main(["--bundle", bundles[1], "--port", "0"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_export.main(["--arch", "vit_tiny_test", "--out", str(tmp_path)])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        VisionModelZoo.get_model("vit_tiny_test")


def test_detection_bundles_not_served_yet(tmp_path):
    with open(tmp_path / "manifest.json", "w") as f:
        json.dump({"format": "vit_torch_tpu.serving.detection/1"}, f)
    with pytest.raises(NotImplementedError, match="detection"):
        load_bundle(str(tmp_path), device="cpu")
